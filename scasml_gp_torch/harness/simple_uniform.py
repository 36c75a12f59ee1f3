"""SimpleUniform: one train + one test comparison of the three solvers.

Port of ``scasml_gp_tpu/harness/simple_uniform.py``: train the GP on
1000+200 points, predict all three solvers on a fresh 1000+200 test set,
NaN-mask, compute L1/L2/rel-L2 + paired t-tests + the GP PDE-residual stats,
and emit the figures (error violin, GP/MLP-vs-SCaSML hexbin diff maps, error
bars, per-solver 3x3 spatiotemporal error heatmaps) plus a text log and
metrics.json with the JAX package's keys.
"""

from __future__ import annotations

import numpy as np
import torch

from scasml_gp_torch.harness import plots
from scasml_gp_torch.harness.base import HarnessBase, to_numpy
from scasml_gp_torch.harness.metrics import summarize


class SimpleUniform(HarnessBase):
    def test(
        self,
        save_path: str,
        rhomax: int = 2,
        num_domain: int = 1000,
        num_boundary: int = 200,
        train_domain: int = 1000,
        train_boundary: int = 200,
        seed: int = 1234,
        make_plots: bool = True,
        profile_dir: str = None,
        **solve_kwargs,
    ):
        path = self._workdir(save_path)
        n = rhomax

        x_dom, x_bdy = self._train_points(train_domain, train_boundary, seed)
        _, t_train = self._timed(self.solver1.GPsolver, x_dom, x_bdy)

        x_test, exact = self._test_points(num_domain, num_boundary, seed + 1)

        # cProfile + torch.profiler trace of the three solve phases
        with self._profile(profile_dir, f"SimpleUniform_rho_{rhomax}"):
            sol1, time1 = self._timed(self.solver1.predict, x_test)
            sol2, time2 = self._timed(
                self.solver2.u_solve, n, rhomax, x_test, **solve_kwargs
            )
            sol3, time3 = self._timed(
                self.solver3.u_solve, n, rhomax, x_test, **solve_kwargs
            )

        summary = summarize(
            {"GP": to_numpy(sol1), "MLP": to_numpy(sol2),
             "SCaSML": to_numpy(sol3)}, exact
        )
        mask = summary.pop("mask")
        errors = summary.pop("errors")

        mask_t = torch.as_tensor(mask, device=x_test.device)
        pde_loss = to_numpy(self.solver1.compute_PDE_loss(x_test[mask_t])).ravel()
        abs_err = {k: np.abs(v) for k, v in errors.items()}
        diff_stats = {
            "GP_vs_SCaSML": plots.hexbin_stats(abs_err["GP"] - abs_err["SCaSML"]),
            "MLP_vs_SCaSML": plots.hexbin_stats(abs_err["MLP"] - abs_err["SCaSML"]),
        }
        result = {
            **summary,
            "times": {"GP": time1, "MLP": time2, "SCaSML": time3,
                      "GP_train": t_train},
            "PDE_loss": {"mean": float(pde_loss.mean()),
                         "std": float(pde_loss.std())},
            "diff_stats": diff_stats,
        }

        with self._log(f"{path}/SimpleUniform.log"):
            print(f"Total time for GP: {time1} seconds")
            print(f"Total time for MLP: {time2} seconds")
            print(f"Total time for ScaSML: {time3} seconds")
            for name in ("GP", "MLP", "SCaSML"):
                print(f"{name} relative L2 error: "
                      f"{summary['metrics'][name]['rel_L2']:.5f}")
            print(f"Real solution L2: {summary['real_sol_L2']:.4f}")
            print(f"PDE loss mean: {result['PDE_loss']['mean']:.4g} "
                  f"std: {result['PDE_loss']['std']:.4g}")
            for pair, t in summary["t_tests"].items():
                print(f"t-test {pair}: t={t['t']:.3f} p={t['p']:.3g}")
            for pair, st in diff_stats.items():
                print(f"{pair}, rho={rhomax}-> positive count: "
                      f"{st['positive_count']} negative count: "
                      f"{st['negative_count']} positive sum: "
                      f"{st['positive_sum']:.4f} negative sum: "
                      f"{st['negative_sum']:.4f}")

        self._dump(path, "metrics.json", result)

        # wandb metric stream with the JAX package's keys
        wb = self._wandb()
        for name in ("GP", "MLP", "SCaSML"):
            wb.log({
                f"mean of {name} L2, rho={rhomax}":
                    float(abs_err[name].mean()),
                f"std of {name} L2, rho={rhomax}": float(abs_err[name].std()),
                f"min of {name} L2, rho={rhomax}": float(abs_err[name].min()),
                f"max of {name} L2, rho={rhomax}": float(abs_err[name].max()),
                f"rel L2 of {name}, rho={rhomax}":
                    summary["metrics"][name]["rel_L2"],
            })
        for pair, t in summary["t_tests"].items():
            wb.log({f"p-value {pair}, rho={rhomax}": t["p"]})
        for pair, st in diff_stats.items():
            # e.g. "positive count of GP_vs_SCaSML, rho=2"
            wb.log({f"{k.replace('_', ' ')} of {pair}, rho={rhomax}": v
                    for k, v in st.items()})
        if profile_dir is not None:
            # upload the cProfile dump as an Artifact
            import os

            wb.log_artifact(
                os.path.join(profile_dir, f"SimpleUniform_rho_{rhomax}.prof"),
                name=f"{type(self.equation).__name__}_rho_{rhomax}_profile",
            )
        wb.finish()

        if make_plots and self.write_files:
            plots.error_violin(errors, f"{path}/Error_Distribution.pdf")
            coords = to_numpy(x_test)[mask, :2]
            plots.diff_hexbin(
                coords, abs_err["GP"] - abs_err["SCaSML"],
                "Error Difference (GP - SCaSML)",
                f"{path}/GP_vs_SCaSML.pdf",
            )
            plots.diff_hexbin(
                coords, abs_err["MLP"] - abs_err["SCaSML"],
                "Error Difference (MLP - SCaSML)",
                f"{path}/MLP_vs_SCaSML.pdf",
            )
            plots.error_bars(summary["metrics"], "rel_L2",
                             f"{path}/Relative_L2.pdf")
            plots.improvement_bars(summary["metrics"], "rel_L2",
                                   f"{path}/Relative_L2_Improvement.pdf")
            for name in ("GP", "MLP", "SCaSML"):
                plots.spatiotemporal_heatmap(
                    coords, abs_err[name], name,
                    f"{path}/{name}_Spatiotemporal_Errors.pdf",
                )
        return result
