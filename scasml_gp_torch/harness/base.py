"""Common harness plumbing.

Port of ``scasml_gp_tpu/harness/base.py``.  A harness is built from
(equation, GP, MLP, ScaSML) and runs with ``.test(save_path, ...)``; it
writes a ``<Harness>.log``, a ``metrics.json`` and PDF figures.  Training and
test points are drawn on the GP's device from a ``torch.Generator`` seeded
with the run's seed; solver outputs go to numpy for the metrics.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from scasml_gp_torch.utils.logio import MaybeWandb, dump_json, tee_log
from scasml_gp_torch.utils.profiling import harness_profile


def to_numpy(t) -> np.ndarray:
    """float64 numpy copy of a solver output."""
    return t.detach().cpu().numpy().astype(np.float64)


class HarnessBase:
    def __init__(self, equation, solver1, solver2, solver3, wandb: bool = False):
        self.equation = equation
        self.dim = equation.n_input - 1
        self.solver1 = solver1   # GP
        self.solver2 = solver2   # MLP
        self.solver3 = solver3   # ScaSML
        self.t0 = equation.t0
        self.T = equation.T
        self.wandb_enabled = wandb
        self.device = solver1.device
        # False on every rank of a mesh but rank 0: that rank alone writes
        # the log, metrics.json and the figures (harness/runner.py)
        self.write_files = True

    # ---- helpers ----
    def _workdir(self, save_path: str) -> str:
        path = os.path.join(save_path, type(self).__name__)
        if self.write_files:
            os.makedirs(path, exist_ok=True)
        return path

    def _log(self, path: str):
        """The harness's text log at ``path`` (stdout and stderr into it);
        a rank that writes no files sends them to os.devnull."""
        return tee_log(path if self.write_files else os.devnull)

    def _wandb(self) -> MaybeWandb:
        """Metric stream for this run; a no-op unless the harness was built
        with ``wandb=True`` and a wandb module imports."""
        return MaybeWandb(
            self.wandb_enabled,
            project="scasml-gp-torch",
            name=f"{type(self.equation).__name__}_{self.dim}d_"
                 f"{type(self).__name__}",
        )

    def _profile(self, profile_dir: Optional[str], tag: str):
        """cProfile + torch.profiler trace around the harness's solve phase."""
        return harness_profile(profile_dir, tag)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _test_points(self, num_domain: int, num_boundary: int, seed: int):
        """Concatenated (domain + boundary) test set on the device, and its
        exact solution as a float64 numpy array.  An equation without a
        closed form falls back to a deep full-history Picard reference, run
        twice with independent seeds; their disagreement is recorded."""
        dom, bdy = self.equation.generate_test_data(
            num_domain, num_boundary, self._generator(seed), device=self.device
        )
        x_test = torch.cat([dom, bdy], dim=0)
        try:
            exact = to_numpy(self.equation.exact_solution(x_test))
        except NotImplementedError:
            from scasml_gp_torch.harness.metrics import mc_reference_solution

            a = mc_reference_solution(self.equation, x_test, seed=123)
            b = mc_reference_solution(self.equation, x_test, seed=456)
            exact = 0.5 * (a + b)
            denom = max(float(np.linalg.norm(exact)), 1e-30)
            half_rel = float(np.linalg.norm(a - b)) / denom
            self.oracle_consistency = {
                "half_run_rel_disagreement": half_rel,
                "oracle_rel_error_estimate": 0.5 * half_rel,
            }
            if half_rel > 0.05:
                print(
                    f"WARNING: MC-oracle half-run disagreement {half_rel:.3f}"
                    " — reported solver metrics may be oracle-dominated",
                    flush=True,
                )
        return x_test, exact

    def _train_points(self, num_domain: int, num_boundary: int, seed: int):
        return self.equation.generate_data(
            num_domain, num_boundary, self._generator(seed), device=self.device
        )

    def _timed(self, fn, *args, **kwargs):
        """fn's result and its wall time in seconds, up to the end of the
        device work it queued."""
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out, time.perf_counter() - start

    def _dump(self, path: str, name: str, data: dict):
        if not self.write_files:
            return
        oc = getattr(self, "oracle_consistency", None)
        if oc is not None and isinstance(data, dict):
            data = dict(data, oracle_consistency=oc)
        dump_json(os.path.join(path, name), data)
