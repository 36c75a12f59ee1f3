"""ScaSML: GP-calibrated multilevel Picard (quadrature and full history).

Port of ``scasml_gp_tpu/picard/scasml.py``.  The recursion runs on the
residual u_breve = u - u_hat of the trained GP:

    f_breve(x, ub, zb) = f(x, ub + u_hat, sigma grad u_hat + zb)
                       - f(x, u_hat, sigma grad u_hat)
    g_breve(x)         = g(x) - u_hat(x)
    leaf level l == 0  : inject eps = PDE residual of u_hat
    u_solve            = u_hat + [lambda] u_breve

Each of the three evaluates the surrogate's posterior at a whole
(batch x MC) node block: u with the gradient, u alone, and u with
dt/div/lap.  For a collocation GP on a GPU each is one launch of the fused
CUDA kernel; the semigroup surrogates (gp/cole_hopf.py, gp/semigroup.py)
evaluate in plain PyTorch.

The optional variance guard (on by default for HJB) shrinks the correction
by a James-Stein factor lambda from the rollout's variance column and a
paired half-sample bias probe, abstains when the probed bias dominates, and
for equations flagged ``escalate_M`` picks the schedule from a shallow-first
ladder.  lambda is a statistic over the whole batch: ``_run`` joins the
batch chunks, and on a mesh gathers the ranks' rows, before ``_guarded_u``
sees them, so every rank computes the same lambda and takes the same ladder
steps.

On the card each rollout, the probes' included, replays a captured CUDA
graph (picard/graphs.py); the guard's statistics are read on the host after
the replays (``_guarded_u``, ``_measured_probe_ratio``).  The guard and the
surrogate's eager u_hat are the spans ``scasml.guard`` and ``scasml.u_hat``
(utils/profiling.py).
"""

from __future__ import annotations

import numpy as np
import torch

from scasml_gp_torch.gp.solver import GP
from scasml_gp_torch.picard.core import (
    PicardModel,
    build_full_history_uz,
    build_quadrature_uz,
)
from scasml_gp_torch.picard import graphs
from scasml_gp_torch.picard.mlp import _PicardBase
from scasml_gp_torch.picard.schedule import (
    approx_parameters,
    count_evaluations_full_history,
    count_evaluations_quadrature,
)
from scasml_gp_torch.utils.profiling import span


class _ScaSMLBase(_PicardBase):
    def __init__(self, equation, gp: GP, batch_chunk=None, center_z=None,
                 time_sampling=None, precision=None, mesh=None,
                 debug_checks=False, seed: int = 0, variance_guard=None,
                 terminal_crn=False, adaptive_clip=None):
        super().__init__(equation, batch_chunk=batch_chunk, center_z=center_z,
                         time_sampling=time_sampling, precision=precision,
                         mesh=mesh, debug_checks=debug_checks,
                         device=gp.device, seed=seed, terminal_crn=terminal_crn)
        self.GP = gp
        self.eval_chunk = gp.eval_chunk
        # Opt-in: clamp u_breve per point to +- adaptive_clip * predict_std(x)
        # (needs a collocation GP).  None keeps the fixed rollout clip only.
        self.adaptive_clip = adaptive_clip
        # The equation's default (HJB sets variance_guard=True); an explicit
        # bool overrides it.
        self.variance_guard = (
            getattr(equation, "variance_guard", False)
            if variance_guard is None else variance_guard
        )
        self.last_lambda = None  # shrink factor of the latest u_solve
        self.last_ladder = []    # schedule candidates the latest u_solve tried

    def eager_reason(self):
        """As the base's, and eager as well over a GP whose posterior runs
        collectives (a mesh of more than one rank) or is a parity mode."""
        return super().eager_reason() or graphs.eager_reason(
            self.device, meshes=(self.GP.mesh,), parity=self.GP.parity)

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
            terminal_crn=self.terminal_crn,
            # f_breve(x, 0, 0) is bitwise zero (val1 == val2), so the
            # level-0 f sweep is skipped exactly.
            f_zero_at_zero=True,
        )

    def _u_hat(self, x_t) -> torch.Tensor:
        with span("scasml.u_hat"):
            return self.GP.predict(x_t)

    def _guarded_u(self, out, x_t, u_breve_half=None, num_valid=None,
                   probe_var_ratio=0.25) -> torch.Tensor:
        """u_hat + lambda u_breve, lambda the James-Stein shrink (u_hat +
        u_breve when the guard is off).

        ``num_valid`` restricts the statistics to the first rows (padded
        batches).  With the paired half-sample probes (a, b): a - b
        estimates 2 Var_half free of bias, and (a + b)/2 - u_breve bounds the
        bias; the bias joins the variance in the shrink's numerator, and
        lambda is 0 when the bias power exceeds the inferred signal power.
        Without probes the rollout's variance column is the numerator.
        One host sync (``last_lambda``)."""
        u_breve = out[:, :1]
        bound = None
        if self.adaptive_clip is not None:
            bound = float(self.adaptive_clip) * self.GP.predict_std(x_t)
            u_breve = torch.clamp(u_breve, -bound, bound)
        if not self.variance_guard:
            return self._u_hat(x_t) + u_breve
        nv = u_breve.shape[0] if num_valid is None else int(num_valid)
        ub_v = u_breve[:nv]
        if u_breve_half is not None:
            a, b = u_breve_half
            if bound is not None:
                # the main estimate's clip, so clipping does not pass for bias
                a = torch.clamp(a, -bound, bound)
                b = torch.clamp(b, -bound, bound)
            a, b = a[:nv], b[:nv]
            var_half = 0.5 * torch.sum((a - b) ** 2)
            var_m = probe_var_ratio * var_half
            delta = 0.5 * (a + b) - ub_v
            bias_sq = torch.clamp_min(
                torch.sum(delta * delta) - 0.5 * var_half - var_m, 0.0)
            num = var_m + bias_sq
        else:
            bias_sq = None
            num = torch.sum(out[:nv, -1:])
        den = torch.sum(ub_v * ub_v)
        lam = torch.clamp(1.0 - num / torch.clamp_min(den, 1e-30), 0.0, 1.0)
        if bias_sq is not None:
            # bias-dominance abstention: a scaled biased correction is worse
            # than none when the bias correlates with the true correction
            signal_sq = torch.clamp_min(den - num, 0.0)
            lam = torch.where(bias_sq > signal_sq, torch.zeros_like(lam), lam)
        self.last_lambda = float(lam)
        return self._u_hat(x_t) + lam * u_breve

    def _auto_schedule_solve(self, solve_at, candidates, x_t):
        """Shallow-first schedule selection (``equation.escalate_M``): return
        the first candidate whose guard accepts (lambda >= the equation's
        ``escalate_M_accept``); when none does, abstain and return u_hat
        with ``last_lambda`` = 0.  Every candidate's rollouts are charged to
        ``evaluation_counter``."""
        lam_accept = float(getattr(self.equation, "escalate_M_accept", 0.5))
        best, best_lam = None, -1.0
        self.last_ladder = []  # (candidate, lambda) in the order tried
        for cand in candidates:
            u = solve_at(cand)
            lam = 0.0 if self.last_lambda is None else self.last_lambda
            self.last_ladder.append((cand, lam))
            if lam > best_lam:
                best, best_lam = u, lam
            if best_lam >= lam_accept:
                self.last_lambda = best_lam
                return best
        self.last_lambda = 0.0
        return self._u_hat(x_t)

    def _measured_probe_ratio(self, out, a_out, b_out, fallback,
                              num_valid=None):
        """Var(full)/Var(probe) from the rollouts' own variance columns,
        clipped to [1e-3, 1]; ``fallback`` when a column sums to <= 0.
        Two host syncs."""
        nv = out.shape[0] if num_valid is None else int(num_valid)
        v_full = float(torch.sum(out[:nv, -1]))
        v_half = 0.5 * float(torch.sum(a_out[:nv, -1]) + torch.sum(b_out[:nv, -1]))
        if not (v_half > 0.0 and v_full > 0.0):
            return fallback
        return float(min(max(v_full / v_half, 1e-3), 1.0))


class ScaSML(_ScaSMLBase):
    """Quadrature ScaSML."""

    def _build(self, schedule_key):
        n, rho, *probe = schedule_key
        tables = approx_parameters(rho, self.T)
        if probe:
            # the bias probe: the same (n, rho) tree with halved MC counts
            tables = tables._replace(Mf=np.maximum(tables.Mf // 2, 1),
                                     Mg=np.maximum(tables.Mg // 2, 1))
        return build_quadrature_uz(self._model(), n, rho, tables,
                                   want_variance=self.variance_guard)

    def uz_solve(self, n: int, rho: int, x_t) -> torch.Tensor:
        out = self._run((int(n), int(rho)), x_t)
        self.evaluation_counter += count_evaluations_quadrature(
            int(n), int(rho), self.T, count_fg=True)
        return out

    def u_solve(self, n: int, rho: int, x_t, num_valid=None) -> torch.Tensor:
        """u_hat + [lambda] u_breve, shape (batch, 1).  A guarded solve adds
        two half-sample probe rollouts; for ``escalate_M`` equations the
        schedule comes from the ladder (1, rho), (1, rho + 1), (n, rho)."""
        x_t = torch.as_tensor(x_t, dtype=torch.float32, device=self.device)
        if getattr(self.equation, "escalate_M", False) and self.variance_guard:
            ladder = [(1, int(rho)), (1, int(rho) + 1)]
            if int(n) > 1:
                ladder.append((int(n), int(rho)))
            return self._auto_schedule_solve(
                lambda c: self._u_solve_at(c[0], c[1], x_t, num_valid),
                ladder, x_t)
        return self._u_solve_at(n, rho, x_t, num_valid)

    def _u_solve_at(self, n: int, rho: int, x_t, num_valid=None) -> torch.Tensor:
        out = self.uz_solve(n, rho, x_t)
        u_half = None
        ratio = 0.25
        if self.variance_guard and rho >= 2:
            probes = []
            for _ in range(2):
                probes.append(self._run((int(n), int(rho), "probe"), x_t))
                # approximate charge of a half-width tree, as the JAX
                # package counts it
                self.evaluation_counter += count_evaluations_quadrature(
                    int(n), int(rho), self.T, count_fg=True) // 2
            a, b = probes
            # fallback: Mg -> Mg//2 halves the terminal-pass variance
            ratio = self._measured_probe_ratio(out, a, b, 0.5, num_valid=num_valid)
            u_half = (a[:, :1], b[:, :1])
        with span("scasml.guard"):
            return self._guarded_u(out, x_t, u_breve_half=u_half,
                                   num_valid=num_valid, probe_var_ratio=ratio)


class ScaSMLFullHistory(_ScaSMLBase):
    """Full-history ScaSML."""

    def _build(self, schedule_key):
        n, M = schedule_key
        return build_full_history_uz(self._model(), n, M,
                                     want_variance=self.variance_guard)

    def uz_solve(self, n: int, rho, x_t, M: int = 3) -> torch.Tensor:
        """(batch, 1 + dim [+ 1]) [u_breve, z_breve, (variance)]; ``rho`` is
        unused."""
        out = self._run((int(n), int(M)), x_t)
        self.evaluation_counter += count_evaluations_full_history(
            int(n), int(M), scasml_variant=True, count_fg=True)
        return out

    def u_solve(self, n: int, rho, x_t, M: int = 3,
                num_valid=None) -> torch.Tensor:
        """u_hat + [lambda] u_breve, shape (batch, 1).  For ``escalate_M``
        equations the schedule comes from the ladder (1, 2M), (1, 4M), ...
        up to ``escalate_M_max``, then (n, M)."""
        x_t = torch.as_tensor(x_t, dtype=torch.float32, device=self.device)
        if not (getattr(self.equation, "escalate_M", False) and self.variance_guard):
            return self._u_solve_at(n, rho, x_t, M, num_valid)
        m_max = int(getattr(self.equation, "escalate_M_max", 12))
        ladder = []
        base = max(2 * int(M), 4)
        while base <= m_max:
            ladder.append((1, base))
            base *= 2
        if not ladder:
            ladder.append((1, max(int(M), 2)))
        if (int(n), int(M)) not in ladder:
            ladder.append((int(n), int(M)))
        return self._auto_schedule_solve(
            lambda c: self._u_solve_at(c[0], rho, x_t, c[1], num_valid),
            ladder, x_t)

    def _u_solve_at(self, n: int, rho, x_t, M: int,
                    num_valid=None) -> torch.Tensor:
        out = self.uz_solve(n, rho, x_t, M)
        u_half = None
        ratio = 0.25
        # bias probes only from M = 4 up, as in the JAX package
        if self.variance_guard and M >= 4:
            a = self.uz_solve(n, rho, x_t, M // 2)
            b = self.uz_solve(n, rho, x_t, M // 2)
            # fallback: terminal MC count M^n -> (M//2)^n
            fallback = float(((M // 2) / M) ** n)
            ratio = self._measured_probe_ratio(out, a, b, fallback,
                                               num_valid=num_valid)
            u_half = (a[:, :1], b[:, :1])
        with span("scasml.guard"):
            return self._guarded_u(out, x_t, u_breve_half=u_half,
                                   num_valid=num_valid, probe_var_ratio=ratio)


ScaSML_full_history = ScaSMLFullHistory
