"""Plain multilevel Picard solvers (no GP calibration).

Port of ``scasml_gp_tpu/picard/mlp.py``: ``MLP.u_solve(n, rho, x_t)`` and
``MLPFullHistory.u_solve(n, rho, x_t, M)``, each with ``uz_solve`` and an
``evaluation_counter``.  Each solver owns a ``torch.Generator`` seeded at
construction; successive solves continue its stream.

With a ``mesh`` (parallel/mesh.py) the test batch is split over its 'data'
axis: each rank rolls out its rows, drawing every node's numbers for the
whole batch and keeping its own (picard/core.py ``ShardedDraws``), and the
ranks gather the outputs.  Every rank then holds the output of the unsplit
rollout at the same seed, and the generators of all ranks stay in step.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from scasml_gp_torch.config import PrecisionPolicy
from scasml_gp_torch.equations.base import Equation
from scasml_gp_torch.picard.core import (
    PicardModel,
    ShardedDraws,
    build_full_history_uz,
    build_quadrature_uz,
)
from scasml_gp_torch.picard.schedule import (
    approx_parameters,
    count_evaluations_full_history,
    count_evaluations_quadrature,
)
from scasml_gp_torch.utils.debug import float_checked
from scasml_gp_torch.utils.device import resolve_device


class _PicardBase:
    """Schedule cache, batch chunking, the solver's RNG stream, the
    evaluation counter and the debug NaN checks."""

    def __init__(self, equation: Equation, batch_chunk: Optional[int] = None,
                 center_z: Optional[bool] = None,
                 time_sampling: Optional[str] = None,
                 precision: Optional[PrecisionPolicy] = None,
                 mesh=None, debug_checks: bool = False,
                 device=None, seed: int = 0,
                 terminal_crn: bool = False,
                 reference_semantics: bool = False):
        from scasml_gp_torch.parallel.mesh import check_mesh

        self.equation = equation
        self.precision = precision or PrecisionPolicy()
        # the test batch split over the mesh's 'data' axis
        self.mesh = check_mesh(mesh)
        self.center_z = (
            getattr(equation, "center_z", False) if center_z is None else center_z
        )
        self.time_sampling = (
            getattr(equation, "time_sampling", "uniform")
            if time_sampling is None else time_sampling
        )
        self.terminal_z = getattr(equation, "terminal_z", "reference")
        equation.geometry()
        self.T = equation.T
        self.t0 = equation.t0
        self.n_input = equation.n_input
        self.n_output = equation.n_output
        self.dim = equation.n_input - 1
        self.evaluation_counter = 0
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.batch_chunk = batch_chunk
        # Debug mode: every op of the rollout is checked for NaN, so a NaN
        # raises at the op that made it (utils/debug.py).
        self.debug_checks = debug_checks
        # the reference-RNG parity probe: frozen terminal draws at every
        # tree node (core.PicardModel.terminal_crn)
        self.terminal_crn = terminal_crn
        # the reference-estimator probe (core.PicardModel.reference_semantics)
        self.reference_semantics = reference_semantics
        self._cache: Dict[Tuple, Callable] = {}

    def _params(self):
        return None

    def _model(self) -> PicardModel:
        eq = self.equation
        return PicardModel(
            f=lambda params, x_t, u, z: eq.f(x_t, u, z),
            g=lambda params, x_t: eq.g(x_t),
            leaf=None,
            mu=float(eq.mu()),
            sigma=float(eq.sigma()),
            T=self.T,
            dim=self.dim,
            clip=float(eq.norm_estimation),
            center_z=self.center_z,
            time_sampling=self.time_sampling,
            terminal_z=self.terminal_z,
            path_dtype=self.precision.rollout,
            terminal_crn=self.terminal_crn,
            reference_semantics=self.reference_semantics,
        )

    def _build(self, schedule_key: Tuple) -> Callable:
        raise NotImplementedError

    def _get_fn(self, schedule_key: Tuple) -> Callable:
        fn = self._cache.get(schedule_key)
        if fn is None:
            fn = self._build(schedule_key)
            if self.debug_checks:
                fn = float_checked(fn)
            self._cache[schedule_key] = fn
        return fn

    def _run(self, schedule_key: Tuple, x_t) -> torch.Tensor:
        """Run the rollout, chunking the batch (padded to whole chunks)."""
        x_t = torch.as_tensor(x_t, dtype=torch.float32, device=self.device)
        fn = self._get_fn(schedule_key)
        params = self._params()
        B = x_t.shape[0]
        chunk = self.batch_chunk
        if chunk is None or B <= chunk:
            return sharded_rollout(fn, x_t, self.gen, params, self.mesh)
        outs = []
        for start in range(0, B, chunk):
            piece = x_t[start: start + chunk]
            pad = chunk - piece.shape[0]
            if pad:
                piece = torch.cat([piece, piece.new_zeros((pad, piece.shape[1]))])
            out = sharded_rollout(fn, piece, self.gen, params, self.mesh)
            outs.append(out[: chunk - pad] if pad else out)
        return torch.cat(outs, dim=0)



def sharded_rollout(fn, x_t, gen, params, mesh) -> torch.Tensor:
    """``fn(x_t, gen, params)`` with the batch split over the mesh's 'data'
    axis: this rank's rows rolled out with the whole batch's draws, then the
    ranks' outputs gathered in order.  Without such a split (no mesh, one
    'data' rank, or a batch that does not divide the axis: the JAX
    package's replicated fallback) it is ``fn``."""
    from scasml_gp_torch.parallel.mesh import all_gather_rows, batch_sharding

    B = x_t.shape[0]
    if mesh is None:
        return fn(x_t, gen, params)
    lo, hi = batch_sharding(mesh, B)
    if hi - lo == B:
        return fn(x_t, gen, params)
    out = fn(x_t[lo:hi], ShardedDraws(gen, mesh.data_index, mesh.data), params)
    return all_gather_rows(out, mesh.data_group, [hi - lo] * mesh.data)


class MLP(_PicardBase):
    """Quadrature multilevel Picard."""

    def _build(self, schedule_key):
        n, rho = schedule_key
        return build_quadrature_uz(self._model(), n, rho,
                                   approx_parameters(rho, self.T))

    def uz_solve(self, n: int, rho: int, x_t) -> torch.Tensor:
        """(batch, 1 + dim) concatenated [u, z]."""
        out = self._run((int(n), int(rho)), x_t)
        self.evaluation_counter += count_evaluations_quadrature(
            int(n), int(rho), self.T)
        return out

    def u_solve(self, n: int, rho: int, x_t) -> torch.Tensor:
        """(batch, 1) u values."""
        return self.uz_solve(n, rho, x_t)[:, :1]


class MLPFullHistory(_PicardBase):
    """Full-history multilevel Picard."""

    def _build(self, schedule_key):
        n, M = schedule_key
        return build_full_history_uz(self._model(), n, M)

    def uz_solve(self, n: int, rho, x_t, M: int = 3) -> torch.Tensor:
        """(batch, 1 + dim) [u, z]; ``rho`` is unused, kept for API parity."""
        out = self._run((int(n), int(M)), x_t)
        self.evaluation_counter += count_evaluations_full_history(int(n), int(M))
        return out

    def u_solve(self, n: int, rho, x_t, M: int = 3) -> torch.Tensor:
        return self.uz_solve(n, rho, x_t, M)[:, :1]


MLP_full_history = MLPFullHistory
