"""SimpleScaling: full-history sample-base sweep.

Port of ``scasml_gp_tpu/harness/simple_scaling.py``: with rho = 1 fixed,
sweep the full-history sample base M = 2..max_base in ``u_solve(..., M=j)``
and plot the same improvement-vs-evaluations curve as InferenceScaling.
Full-history solvers only.
"""

from __future__ import annotations

import numpy as np

from scasml_gp_torch.harness import plots
from scasml_gp_torch.harness.base import HarnessBase, to_numpy
from scasml_gp_torch.harness.metrics import valid_mask
from scasml_gp_torch.utils.logio import tee_log


class SimpleScaling(HarnessBase):
    def test(
        self,
        save_path: str,
        max_base: int = 15,
        n_samples: int = 1000,
        train_domain: int = 1000,
        train_boundary: int = 200,
        gn_steps: int = 20,
        seed: int = 1234,
        make_plots: bool = True,
        profile_dir: str = None,
    ):
        path = self._workdir(save_path)
        x_dom, x_bdy = self._train_points(train_domain, train_boundary, seed)
        self.solver1.GPsolver(x_dom, x_bdy, GN_steps=gn_steps)
        x_test, exact = self._test_points(n_samples, n_samples // 5, seed + 1)

        err = {"GP": [], "MLP": [], "SCaSML": []}
        counters, bases = [], []
        rho = 1
        with self._profile(profile_dir, f"SimpleScaling_maxbase_{max_base}"):
            for M in range(2, max_base + 1):
                sol1 = to_numpy(self.solver1.predict(x_test))
                sol2 = to_numpy(self.solver2.u_solve(rho, rho, x_test, M=M))
                sol3 = to_numpy(self.solver3.u_solve(rho, rho, x_test, M=M))
                mask = valid_mask(exact, sol1, sol2, sol3)
                ex = exact.reshape(-1)[mask]
                norm = np.linalg.norm(ex)
                for name, sol in (("GP", sol1), ("MLP", sol2), ("SCaSML", sol3)):
                    err[name].append(
                        float(np.linalg.norm(sol.reshape(-1)[mask] - ex) / norm)
                    )
                counters.append(int(self.solver3.evaluation_counter))
                bases.append(M)

        emin = np.minimum(np.asarray(err["GP"]), np.asarray(err["MLP"]))
        improvement = (emin - np.asarray(err["SCaSML"])) / emin * 100.0

        result = {
            "sample_base": bases,
            "rel_L2": err,
            "evaluation_counter": counters,
            "improvement_pct": improvement.tolist(),
        }
        with tee_log(f"{path}/SimpleScaling.log"):
            for M, c, imp in zip(bases, counters, improvement):
                print(f"M={M}: evals={c} improvement={imp:.2f}%")
        self._dump(path, "metrics.json", result)

        wb = self._wandb()
        for M, c, imp in zip(bases, counters, improvement):
            wb.log({f"evaluations, M={M}": c,
                    f"improvement pct, M={M}": float(imp)})
        wb.finish()
        if make_plots:
            plots.improvement_curve(
                np.asarray(counters, np.float64), improvement,
                "Evaluation Numbers",
                f"{path}/SimpleScaling_Improvement.pdf",
            )
        return result
