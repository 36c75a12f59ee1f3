"""ComputingBudget: equal-budget comparison of the three solvers.

Port of ``scasml_gp_tpu/harness/computing_budget.py``: per budget level b,
GP gets GN_steps = 5b, MLP gets rho = 2 + b - 1, ScaSML gets GN_steps/2 and
the same rho; fresh solver instances per level, built on the originals'
device with their precision policy and batch chunk; errors and wall-clock
per level, error-vs-budget figures, final log table.
"""

from __future__ import annotations

import numpy as np

from scasml_gp_torch.harness import plots
from scasml_gp_torch.harness.base import HarnessBase, to_numpy
from scasml_gp_torch.harness.metrics import valid_mask
from scasml_gp_torch.utils.logio import tee_log


class ComputingBudget(HarnessBase):
    def test(
        self,
        save_path: str,
        budget_levels=(1, 2, 3),
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
        x_dom, x_bdy = self._train_points(train_domain, train_boundary, seed)
        x_test, exact = self._test_points(num_domain, num_boundary, seed + 1)

        base_gn_steps = 5     # reference ComputingBudget.py:122-123
        base_rho = 2

        errors = {"GP": [], "MLP": [], "SCaSML": []}
        times = {"GP": [], "MLP": [], "SCaSML": []}
        levels_used = []

        with self._profile(profile_dir, "ComputingBudget"):
            for budget in budget_levels:
                gn_steps = base_gn_steps * budget
                rho = base_rho + budget - 1

                # Fresh instances per level (the reference deep-copies), on
                # the originals' device, with their precision and chunking.
                gp_kw = dict(precision=self.solver1.precision,
                             device=self.solver1.device)
                gp = type(self.solver1)(self.equation, self.solver1.config, **gp_kw)
                mlp = type(self.solver2)(self.equation,
                                         precision=self.solver2.precision,
                                         batch_chunk=self.solver2.batch_chunk,
                                         device=self.solver1.device)
                sca_gp = type(self.solver1)(self.equation, self.solver1.config,
                                            **gp_kw)
                sca = type(self.solver3)(self.equation, sca_gp,
                                         precision=self.solver3.precision,
                                         batch_chunk=self.solver3.batch_chunk)

                _, t_train = self._timed(gp.GPsolver, x_dom, x_bdy, gn_steps)
                sol_gp, t_inf = self._timed(gp.predict, x_test)
                times["GP"].append(t_train + t_inf)

                sol_mlp, t_mlp = self._timed(
                    mlp.u_solve, rho, rho, x_test, **solve_kwargs
                )
                times["MLP"].append(t_mlp)

                _, t_train3 = self._timed(
                    sca_gp.GPsolver, x_dom, x_bdy, max(1, gn_steps // 2)
                )
                sol_sca, t_inf3 = self._timed(
                    sca.u_solve, rho, rho, x_test, **solve_kwargs
                )
                times["SCaSML"].append(t_train3 + t_inf3)

                sols = {"GP": to_numpy(sol_gp), "MLP": to_numpy(sol_mlp),
                        "SCaSML": to_numpy(sol_sca)}
                mask = valid_mask(exact, *sols.values())
                ex = exact.reshape(-1)[mask]
                norm = np.linalg.norm(ex)
                for name, sol in sols.items():
                    errors[name].append(
                        float(np.linalg.norm(sol.reshape(-1)[mask] - ex) / norm)
                    )
                levels_used.append(int(budget))

        result = {
            "budget_levels": levels_used,
            "rel_L2": errors,
            "times": times,
        }
        if getattr(self.equation, "escalate_M", False):
            # the budget ladder grows MLP's depth rho = 2 + b - 1, and for a
            # gradient-quadratic generator deeper trees amplify z-noise into
            # bias: plain MLP is expected to worsen with budget here
            result["notes"] = {
                "MLP": "gradient-quadratic generator: plain MLP diverges "
                       "with the budget ladder's growing depth (documented "
                       "anti-pattern, reports/RESULTS.md); ScaSML "
                       "auto-selects a shallow schedule via its "
                       "variance-guard probe",
            }
        with tee_log(f"{path}/ComputingBudget.log"):
            print(f"{'budget':>8} {'GP':>12} {'MLP':>12} {'SCaSML':>12}")
            for i, b in enumerate(levels_used):
                print(f"{b:>8} {errors['GP'][i]:>12.4e} "
                      f"{errors['MLP'][i]:>12.4e} {errors['SCaSML'][i]:>12.4e}")
            for name in times:
                print(f"{name} times: {[round(t, 3) for t in times[name]]}")
        self._dump(path, "metrics.json", result)

        wb = self._wandb()
        for i, b in enumerate(levels_used):
            wb.log({f"{name} rel L2, budget={b}": errors[name][i]
                    for name in errors})
        wb.finish()
        if make_plots:
            plots.budget_curves(levels_used, errors,
                                f"{path}/ComputingBudget_Errors.pdf")
            plots.budget_improvement_bars(
                levels_used, errors, f"{path}/Improvement_Bar_Chart.pdf"
            )
        return result
