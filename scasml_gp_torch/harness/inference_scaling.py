"""InferenceScaling: ScaSML improvement vs inference compute.

Port of ``scasml_gp_tpu/harness/inference_scaling.py``: train the GP once,
then for rho = 1..rhomax run MLP and ScaSML at n = rho and plot
improvement% = (min(GP, MLP) - SCaSML) / min(GP, MLP) * 100 against
ScaSML's cumulative ``evaluation_counter`` on a log x-axis.
"""

from __future__ import annotations

import numpy as np

from scasml_gp_torch.harness import plots
from scasml_gp_torch.harness.base import HarnessBase, to_numpy
from scasml_gp_torch.harness.metrics import valid_mask
from scasml_gp_torch.utils.logio import tee_log


class InferenceScaling(HarnessBase):
    def test(
        self,
        save_path: str,
        rhomax: int = 3,
        n_samples: int = 1000,
        train_domain: int = 1000,
        train_boundary: int = 200,
        gn_steps: int = 20,
        seed: int = 1234,
        make_plots: bool = True,
        profile_dir: str = None,
        **solve_kwargs,
    ):
        path = self._workdir(save_path)
        x_dom, x_bdy = self._train_points(train_domain, train_boundary, seed)
        self.solver1.GPsolver(x_dom, x_bdy, GN_steps=gn_steps)
        x_test, exact = self._test_points(n_samples, n_samples // 5, seed + 1)

        err = {"GP": [], "MLP": [], "SCaSML": []}
        counters = []
        with self._profile(profile_dir, f"InferenceScaling_rhomax_{rhomax}"):
            for rho in range(1, rhomax + 1):
                sol1 = to_numpy(self.solver1.predict(x_test))
                sol2 = to_numpy(self.solver2.u_solve(rho, rho, x_test, **solve_kwargs))
                sol3 = to_numpy(self.solver3.u_solve(rho, rho, x_test, **solve_kwargs))
                mask = valid_mask(exact, sol1, sol2, sol3)
                ex = exact.reshape(-1)[mask]
                norm = np.linalg.norm(ex)
                for name, sol in (("GP", sol1), ("MLP", sol2), ("SCaSML", sol3)):
                    err[name].append(
                        float(np.linalg.norm(sol.reshape(-1)[mask] - ex) / norm)
                    )
                counters.append(int(self.solver3.evaluation_counter))

        emin = np.minimum(np.asarray(err["GP"]), np.asarray(err["MLP"]))
        improvement = (emin - np.asarray(err["SCaSML"])) / emin * 100.0

        result = {
            "rho": list(range(1, rhomax + 1)),
            "rel_L2": err,
            "evaluation_counter": counters,
            "improvement_pct": improvement.tolist(),
        }
        if getattr(self.equation, "escalate_M", False):
            # for a gradient-quadratic generator the plain MLP diverges with
            # depth (level l estimates z from ~M^(n-l) paths and f turns that
            # variance into a depth-amplified bias); ScaSML's guarded ladder
            # picks a shallow schedule instead
            result["notes"] = {
                "MLP": "gradient-quadratic generator: plain MLP diverges "
                       "with depth rho (documented anti-pattern, "
                       "reports/RESULTS.md); ScaSML auto-selects a shallow "
                       "schedule via its variance-guard probe",
            }
        with tee_log(f"{path}/InferenceScaling.log"):
            for rho, c, imp in zip(result["rho"], counters, improvement):
                print(f"rho={rho}: evals={c} improvement={imp:.2f}%")
        self._dump(path, "metrics.json", result)

        wb = self._wandb()
        for rho, c, imp in zip(result["rho"], counters, improvement):
            wb.log({f"evaluations, rho={rho}": c,
                    f"improvement pct, rho={rho}": float(imp)})
        wb.finish()
        if make_plots:
            plots.improvement_curve(
                np.asarray(counters, np.float64), improvement,
                "Evaluation Numbers",
                f"{path}/InferenceScaling_Improvement.pdf",
            )
        return result
