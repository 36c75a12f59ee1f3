"""ScaSML: GP-calibrated multilevel Picard (quadrature variant).

Port of ``scasml_gp_tpu/picard/scasml.py`` without the variance guard.  The
recursion runs on the residual u_breve = u - u_hat of the trained GP:

    f_breve(x, ub, zb) = f(x, ub + u_hat, sigma grad u_hat + zb)
                       - f(x, u_hat, sigma grad u_hat)
    g_breve(x)         = g(x) - u_hat(x)
    leaf level l == 0  : inject eps = PDE residual of u_hat
    u_solve            = u_hat + u_breve

Each of the three evaluates the GP posterior at a whole (batch x MC) node
block: u with the gradient, u alone, and u with dt/div/lap.  On a GPU each is
one launch of the fused CUDA kernel.
"""

from __future__ import annotations

import torch

from scasml_gp_torch.gp.solver import GP
from scasml_gp_torch.picard.core import PicardModel, build_quadrature_uz
from scasml_gp_torch.picard.mlp import _PicardBase
from scasml_gp_torch.picard.schedule import (
    approx_parameters,
    count_evaluations_quadrature,
)


class _ScaSMLBase(_PicardBase):
    def __init__(self, equation, gp: GP, batch_chunk=None, center_z=None,
                 time_sampling=None, precision=None, seed: int = 0,
                 variance_guard=None, terminal_crn=False, adaptive_clip=None):
        super().__init__(equation, batch_chunk=batch_chunk, center_z=center_z,
                         time_sampling=time_sampling, precision=precision,
                         device=gp.device, seed=seed, terminal_crn=terminal_crn)
        guard = (getattr(equation, "variance_guard", False)
                 if variance_guard is None else variance_guard)
        if guard or adaptive_clip is not None:
            raise NotImplementedError(
                "the variance guard, its probes and schedule selection, and "
                "adaptive_clip are not ported"
            )
        self.GP = gp
        self.eval_chunk = gp.eval_chunk
        self.variance_guard = False

    def _params(self):
        if self.GP.state is None:
            raise RuntimeError("GP surrogate not trained; call GP.GPsolver first.")
        return self.GP.state

    def _model(self) -> PicardModel:
        eq = self.equation
        gp = self.GP

        def f_breve(params, x_t, u_breve, z_breve):
            out = gp.posterior_u(params, x_t, want_grad=True)
            u_hat = out.u[:, None]
            grad_sp = out.grad[:, :-1]
            sig = eq.sigma(x_t)
            val1 = eq.f(x_t, u_breve + u_hat, sig * grad_sp + z_breve)
            val2 = eq.f(x_t, u_hat, sig * grad_sp)
            return val1 - val2

        def g_breve(params, x_t):
            return eq.g(x_t) - gp.posterior_u(params, x_t).u[:, None]

        def leaf(params, x_t):
            return gp.residual_u(params, x_t)

        return PicardModel(
            f=f_breve,
            g=g_breve,
            leaf=leaf,
            mu=float(eq.mu()),
            sigma=float(eq.sigma()),
            T=self.T,
            dim=self.dim,
            clip=float(eq.uncertainty),
            center_z=self.center_z,
            time_sampling=self.time_sampling,
            terminal_z=self.terminal_z,
            path_dtype=self.precision.rollout,
            # f_breve(x, 0, 0) is bitwise zero (val1 == val2), so the
            # level-0 f sweep is skipped exactly.
            f_zero_at_zero=True,
        )

    def _u_hat(self, x_t) -> torch.Tensor:
        return self.GP.predict(x_t)


class ScaSML(_ScaSMLBase):
    """Quadrature ScaSML."""

    def _build(self, schedule_key):
        n, rho = schedule_key
        return build_quadrature_uz(self._model(), n, rho,
                                   approx_parameters(rho, self.T))

    def uz_solve(self, n: int, rho: int, x_t) -> torch.Tensor:
        out = self._run((int(n), int(rho)), x_t)
        self.evaluation_counter += count_evaluations_quadrature(
            int(n), int(rho), self.T, count_fg=True)
        return out

    def u_solve(self, n: int, rho: int, x_t) -> torch.Tensor:
        """u_hat + u_breve, shape (batch, 1)."""
        x_t = torch.as_tensor(x_t, dtype=torch.float32, device=self.device)
        return self._u_hat(x_t) + self.uz_solve(n, rho, x_t)[:, :1]
