"""ConvergenceRate: empirical error-vs-training-size slopes.

Port of ``scasml_gp_tpu/harness/convergence_rate.py``: sweep the training
size (100..1000 domain / 20..200 boundary), set rho = floor(log N / log log N)
per size, fit log-log slopes of the GP and ScaSML relative-L2 errors, and plot
both with their fitted lines.
"""

from __future__ import annotations

import numpy as np

from scasml_gp_torch.harness import plots
from scasml_gp_torch.harness.base import HarnessBase, to_numpy
from scasml_gp_torch.harness.metrics import valid_mask


class ConvergenceRate(HarnessBase):
    def test(
        self,
        save_path: str,
        n_samples: int = 1000,
        gn_steps: int = 20,
        sizes_domain=None,
        sizes_boundary=None,
        seed: int = 1234,
        make_plots: bool = True,
        profile_dir: str = None,
        **solve_kwargs,
    ):
        path = self._workdir(save_path)
        if sizes_domain is None:
            sizes_domain = list(range(100, 1100, 100))
        if sizes_boundary is None:
            sizes_boundary = list(range(20, 220, 20))

        x_test, exact = self._test_points(n_samples, n_samples // 5, seed + 1)

        train_sizes = np.asarray(sizes_domain) + np.asarray(sizes_boundary)
        err_gp, err_sca = [], []
        with self._profile(profile_dir, "ConvergenceRate"):
            for j, (nd, nb) in enumerate(zip(sizes_domain, sizes_boundary)):
                x_dom, x_bdy = self._train_points(nd, nb, seed + 100 + j)
                total = nd + nb
                # rho = floor(log N / log log N)
                # (reference ConvergenceRate.py:111)
                rho = int(np.log(total) / np.log(np.log(total)))
                self.solver1.GPsolver(x_dom, x_bdy, GN_steps=gn_steps)
                sol1 = to_numpy(self.solver1.predict(x_test))
                sol3 = to_numpy(self.solver3.u_solve(rho, rho, x_test, **solve_kwargs))
                mask = valid_mask(exact, sol1, sol3)
                ex = exact.reshape(-1)[mask]
                norm = np.linalg.norm(ex)
                err_gp.append(np.linalg.norm(sol1.reshape(-1)[mask] - ex) / norm)
                err_sca.append(np.linalg.norm(sol3.reshape(-1)[mask] - ex) / norm)

        eps = 1e-10
        logx = np.log10(train_sizes + eps)
        slope_gp, _ = np.polyfit(logx, np.log10(np.asarray(err_gp) + eps), 1)
        slope_sca, _ = np.polyfit(logx, np.log10(np.asarray(err_sca) + eps), 1)

        result = {
            "train_sizes": train_sizes.tolist(),
            "rel_L2": {"GP": err_gp, "SCaSML": err_sca},
            "slopes": {"GP": float(slope_gp), "SCaSML": float(slope_sca)},
        }
        with self._log(f"{path}/ConvergenceRate.log"):
            for s, e1, e3 in zip(train_sizes, err_gp, err_sca):
                print(f"N={s}: GP {e1:.4e}  SCaSML {e3:.4e}")
            print(f"GP slope: {slope_gp:.3f}")
            print(f"SCaSML slope: {slope_sca:.3f}")
        self._dump(path, "metrics.json", result)

        wb = self._wandb()
        for s, e1, e3 in zip(train_sizes, err_gp, err_sca):
            wb.log({f"GP rel L2, N={int(s)}": float(e1),
                    f"SCaSML rel L2, N={int(s)}": float(e3)})
        wb.log({"GP slope": float(slope_gp),
                "SCaSML slope": float(slope_sca)})
        wb.finish()

        if make_plots and self.write_files:
            plots.loglog_convergence(
                train_sizes,
                {"GP": np.asarray(err_gp), "SCaSML": np.asarray(err_sca)},
                result["slopes"],
                f"{path}/ConvergenceRate.pdf",
            )
        return result
