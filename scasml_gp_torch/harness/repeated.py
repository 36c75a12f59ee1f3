"""RepeatedExperiment: statistics over repeated runs with fresh test sets.

Port of ``scasml_gp_tpu/harness/repeated.py``: train the GP once, then run
``num_repetitions`` repetitions with seeds 42+i over fresh test sets; report
mean/std/95% CI of rel-L2, L1, L2 across repetitions, paired t-tests across
the repetition axis, timing statistics, and box plots.
"""

from __future__ import annotations

import numpy as np
from scipy import stats as sstats

from scasml_gp_torch.harness import plots
from scasml_gp_torch.harness.base import HarnessBase, to_numpy
from scasml_gp_torch.harness.metrics import error_metrics, valid_mask

_SOLVERS = ("GP", "MLP", "SCaSML")


class RepeatedExperiment(HarnessBase):
    def test(
        self,
        save_path: str,
        rhomax: int = 2,
        num_domain: int = 1000,
        num_boundary: int = 200,
        train_domain: int = 1000,
        train_boundary: int = 200,
        num_repetitions: int = 10,
        seed: int = 1234,
        make_plots: bool = True,
        profile_dir: str = None,
        **solve_kwargs,
    ):
        path = self._workdir(save_path)
        n = rhomax

        x_dom, x_bdy = self._train_points(train_domain, train_boundary, seed)
        _, t_train = self._timed(self.solver1.GPsolver, x_dom, x_bdy)

        per_metric = {m: {s: [] for s in _SOLVERS} for m in ("L1", "L2", "rel_L2")}
        times = {s: [] for s in _SOLVERS}

        with self._profile(profile_dir, f"RepeatedExperiment_rho_{rhomax}"):
            for rep in range(num_repetitions):
                # fresh test set per repetition, seeds 42+i
                x_test, exact = self._test_points(
                    num_domain, num_boundary, 42 + rep
                )
                sol1, t1 = self._timed(self.solver1.predict, x_test)
                sol2, t2 = self._timed(
                    self.solver2.u_solve, n, rhomax, x_test, **solve_kwargs
                )
                sol3, t3 = self._timed(
                    self.solver3.u_solve, n, rhomax, x_test, **solve_kwargs
                )
                sol1, sol2, sol3 = (to_numpy(o) for o in (sol1, sol2, sol3))
                mask = valid_mask(exact, sol1, sol2, sol3)
                ex = exact.reshape(-1)[mask]
                for name, sol, t in (
                    ("GP", sol1, t1), ("MLP", sol2, t2), ("SCaSML", sol3, t3)
                ):
                    m = error_metrics(np.asarray(sol).reshape(-1)[mask], ex)
                    for key in per_metric:
                        per_metric[key][name].append(m[key])
                    times[name].append(t)

        def _stats(vals):
            vals = np.asarray(vals, np.float64)
            mean = vals.mean()
            std = vals.std(ddof=1) if len(vals) > 1 else 0.0
            half = (
                sstats.t.ppf(0.975, len(vals) - 1) * std / np.sqrt(len(vals))
                if len(vals) > 1 else 0.0
            )
            return {"mean": float(mean), "std": float(std),
                    "ci95": [float(mean - half), float(mean + half)]}

        result = {
            "num_repetitions": num_repetitions,
            "metrics": {
                m: {s: _stats(per_metric[m][s]) for s in _SOLVERS}
                for m in per_metric
            },
            "times": {s: _stats(times[s]) for s in _SOLVERS},
            "GP_train_time": t_train,
            "t_tests": {},
            "raw": per_metric,
        }
        # full paired t-test matrix: each of rel_L2/L1/L2 x GP-vs-SCaSML,
        # MLP-vs-SCaSML, GP-vs-MLP
        for metric in ("rel_L2", "L1", "L2"):
            for a, b in (("GP", "SCaSML"), ("MLP", "SCaSML"), ("GP", "MLP")):
                t, p = sstats.ttest_rel(
                    per_metric[metric][a], per_metric[metric][b]
                )
                result["t_tests"][f"{metric}:{a}_vs_{b}"] = {
                    "t": float(t), "p": float(p)
                }

        with self._log(f"{path}/RepeatedExperiment.log"):
            for m in per_metric:
                for s in _SOLVERS:
                    st = result["metrics"][m][s]
                    print(f"Mean {m} ({s}): {st['mean']:.4e} "
                          f"std {st['std']:.2e} CI {st['ci95']}")
            for s in _SOLVERS:
                print(f"Execution time ({s}): mean "
                      f"{result['times'][s]['mean']:.4f}s")
            for pair, t in result["t_tests"].items():
                print(f"t-test {pair}: t={t['t']:.6f} p={t['p']:.6e}")

        self._dump(path, "metrics.json", result)

        wb = self._wandb()
        for m in per_metric:
            for s in _SOLVERS:
                st = result["metrics"][m][s]
                wb.log({f"mean of {s} {m}, rho={rhomax}": st["mean"],
                        f"std of {s} {m}, rho={rhomax}": st["std"]})
        for pair, t in result["t_tests"].items():
            wb.log({f"p-value {pair}, rho={rhomax}": t["p"]})
        wb.finish()

        if make_plots and self.write_files:
            plots.repetition_box(
                {s: np.asarray(per_metric["rel_L2"][s]) for s in _SOLVERS},
                "Relative $L^2$ error", f"{path}/RelL2_Repetitions.pdf",
            )
            plots.repetition_box(
                {s: np.asarray(per_metric["L1"][s]) for s in _SOLVERS},
                "$L^1$ error", f"{path}/L1_Repetitions.pdf",
            )
            plots.repetition_box(
                {s: np.asarray(times[s]) for s in _SOLVERS},
                "Wall-clock (s)", f"{path}/Times_Repetitions.pdf",
            )
            plots.error_bars(
                {s: {"rel_L2": result["metrics"]["rel_L2"][s]["mean"]}
                 for s in _SOLVERS},
                "rel_L2", f"{path}/Mean_RelL2.pdf",
            )
        return result
