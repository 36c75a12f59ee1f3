"""Gaussian-process PDE surrogate: damped-Newton training and evaluation.

Port of the dense path of ``scasml_gp_tpu/gp/solver.py``.  The loss is

    loss(sol) = b(sol)^T (K + nugget I)^{-1} b(sol),
    b = [z1, g_bdy, z3, F(z1, z3, z5), z5],

minimised by damped Newton with the analytic Hessian, an 8-way backtracking
line search and the reference's damping schedule.  (K + nugget I)^{-1} is
formed once, so each step is matrix products, one 3N x 3N solve and
elementwise work.  The step loop is a Python loop whose stop/accept/damping
state stays in device tensors: it makes no host sync.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from scasml_gp_torch.config import GPConfig, PrecisionPolicy
from scasml_gp_torch.equations.base import Equation
from scasml_gp_torch.gp.gram import gram_matrix, regularized_factorization
from scasml_gp_torch.gp.kernels import kernel_gammas
from scasml_gp_torch.gp.posterior import posterior_eval
from scasml_gp_torch.gp.state import GPState


class GPForm:
    """Per-equation GP pieces.  F maps (z1, z3, z5) to du/dt on the interior
    set, from du/dt = -mu div u - (sigma^2/2) Lap u - f(x, u, sigma grad u),
    with z1 ~ u, z3 ~ Lap u, z5 ~ div u."""

    def __init__(self, equation: Equation):
        self.equation = equation

    def rhs_f(self, x_dom: torch.Tensor) -> torch.Tensor:
        return torch.zeros((x_dom.shape[0],), dtype=torch.float32,
                           device=x_dom.device)

    def F(self, z1, z3, z5, rhs):
        raise NotImplementedError

    def dF(self, z1, z3, z5) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Diagonals of dF/dz1, dF/dz3, dF/dz5 (F_i depends only on entry i)."""
        raise NotImplementedError

    def d2F_contraction(self, w, z1, z3, z5):
        """{(a, b): diagonal} of sum_i w_i Hess(F_i), a, b in {0, 1, 2}."""
        return {}

    def residual(self, x, u, dt_u, div_u, lap_u) -> torch.Tensor:
        raise NotImplementedError


class GradDependentForm(GPForm):
    """F = -sigma^2 z1 z5 + (1/d + sigma^2/2) z5 - (sigma^2/2) z3 + rhs."""

    def F(self, z1, z3, z5, rhs):
        sig2 = self.equation.sigma() ** 2
        d = self.equation.dim
        return -sig2 * z1 * z5 + (1.0 / d + sig2 / 2.0) * z5 - (sig2 / 2.0) * z3 + rhs

    def dF(self, z1, z3, z5):
        sig2 = self.equation.sigma() ** 2
        d = self.equation.dim
        ones = torch.ones_like(z1)
        return (-sig2 * z5, -(sig2 / 2.0) * ones,
                -sig2 * z1 + (1.0 / d + sig2 / 2.0) * ones)

    def d2F_contraction(self, w, z1, z3, z5):
        v = -(self.equation.sigma() ** 2) * w
        return {(0, 2): v, (2, 0): v}

    def residual(self, x, u, dt_u, div_u, lap_u):
        sig2 = self.equation.sigma() ** 2
        d = self.equation.dim
        return dt_u + (sig2 * u - 1.0 / d - sig2 / 2.0) * div_u + (sig2 / 2.0) * lap_u


class _TrainOut(NamedTuple):
    sol: torch.Tensor
    right_vector: torch.Tensor
    loss_history: torch.Tensor
    grad_norm: torch.Tensor


class GP:
    """Gaussian kernel PDE solver; subclass with a GPForm per equation."""

    form_cls = None

    def __init__(self, equation: Equation, config: Optional[GPConfig] = None,
                 precision: Optional[PrecisionPolicy] = None, device="cpu"):
        self.equation = equation
        self.config = config or GPConfig()
        self.precision = precision or PrecisionPolicy()
        self.device = torch.device(device)
        cfg = self.config
        if cfg.laplacian != "exact" or cfg.parity_fp16:
            raise NotImplementedError(
                "parity modes (laplacian='subset', parity_fp16) are not ported"
            )
        if cfg.posterior_backend not in ("auto", "xla"):
            raise ValueError(f"unknown posterior backend {cfg.posterior_backend!r}")
        if self.precision.gram != "float32":
            raise NotImplementedError("only the float32 gram policy is ported")
        equation.geometry()
        self.T = equation.T
        self.t0 = equation.t0
        self.n_input = equation.n_input
        self.n_output = equation.n_output
        self.d = equation.dim
        gs, gt, gr = kernel_gammas(equation.sigma(), self.d, cfg.time_scale,
                                   cfg.ridge_scale)
        c = cfg.gamma_scale
        self.gamma = (gs * c, gt * c, gr * c)
        self.nugget = cfg.nugget
        self.form: GPForm = self.form_cls(equation) if self.form_cls else None
        self.state: Optional[GPState] = None
        self.eval_chunk = cfg.eval_chunk or 4096

    # ------------------------------------------------------------------ train
    def GPsolver(self, x_t_domain, x_t_boundary, GN_steps: Optional[int] = None,
                 sol0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Train the surrogate; returns the posterior mean on the interior
        set, shape (N, 1).  ``sol0`` (3N,) replaces the initial point, which
        is otherwise drawn from a generator seeded with 0."""
        cfg = self.config
        steps = cfg.gn_steps if GN_steps is None else int(GN_steps)
        x_dom = torch.as_tensor(x_t_domain, dtype=torch.float32, device=self.device)
        x_bdy = torch.as_tensor(x_t_boundary, dtype=torch.float32, device=self.device)
        self._check_train_backend(x_dom, x_bdy)
        bdy_g = self.equation.g(x_bdy)[:, 0].to(torch.float32)
        rhs = self.form.rhs_f(x_dom).to(torch.float32)
        gamma = torch.tensor(self.gamma, dtype=torch.float32, device=self.device)
        out = self._train(x_dom, x_bdy, bdy_g, rhs, gamma, self.nugget, steps,
                          cfg.damping, cfg.grad_tol, sol0)
        self.state = GPState(
            x_dom=x_dom, x_bdy=x_bdy, right_vector=out.right_vector,
            sol=out.sol, gamma=gamma, loss_history=out.loss_history,
        )
        self.loss_history = out.loss_history
        return self.predict(x_dom)

    def _check_train_backend(self, x_dom, x_bdy) -> None:
        cfg = self.config
        backend = cfg.train_backend
        if backend == "auto":
            phi = 4 * x_dom.shape[0] + x_bdy.shape[0]
            backend = "distributed" if phi > cfg.dense_phi_max else "dense"
        if backend == "distributed":
            raise NotImplementedError(
                "the distributed (dual-CG) trainer is not ported; phi = "
                f"{4 * x_dom.shape[0] + x_bdy.shape[0]} > dense_phi_max = "
                f"{cfg.dense_phi_max} needs it"
            )
        if backend != "dense":
            raise ValueError(f"unknown train_backend {cfg.train_backend!r}")

    def _train(self, x_dom, x_bdy, bdy_g, rhs, gamma, nugget, steps, damping,
               grad_tol, sol0: Optional[torch.Tensor] = None) -> _TrainOut:
        """The dense Newton train for kernel precisions ``gamma`` (3,) and
        ``nugget``, shared by ``GPsolver`` and the tuner's candidates.
        ``sol0`` (3N,) is the initial point; None draws it from a generator
        seeded with 0, times ``config.init_scale``."""
        N = x_dom.shape[0]
        dev = x_dom.device
        if sol0 is None:
            gen = torch.Generator(device=dev).manual_seed(0)
            sol0 = torch.randn((3 * N,), generator=gen, device=dev) * self.config.init_scale
        sol0 = torch.as_tensor(sol0, dtype=torch.float32, device=dev)
        if sol0.shape != (3 * N,):
            raise ValueError(f"sol0 must have shape ({3 * N},), got {tuple(sol0.shape)}")
        K = gram_matrix(x_dom, x_bdy, gamma, self.d)
        _, C = regularized_factorization(K, nugget)
        del K
        return self._newton_body(C, bdy_g, rhs, steps, damping, grad_tol, sol0)

    def _newton_body(self, C, bdy_g, rhs, steps, damping, grad_tol,
                     sol0) -> _TrainOut:
        N = rhs.shape[0]
        Nb = bdy_g.shape[0]
        dev = C.device
        # Row sets of b = [z1 (R1), bdy (R2), z3 (R3), F (R4), z5 (R5)].
        i1, i2, i3, i4 = N, N + Nb, 2 * N + Nb, 3 * N + Nb
        grp_rows = {0: (0, i1), 1: (i2, i3), 2: (i4, 4 * N + Nb)}
        C44 = C[i3:i4, i3:i4]
        form = self.form

        def b_of(sol):  # sol (..., 3N) -> b (..., phi)
            z1, z3, z5 = sol[..., :N], sol[..., N:2 * N], sol[..., 2 * N:]
            g = bdy_g.expand(sol.shape[:-1] + (Nb,))
            return torch.cat([z1, g, z3, form.F(z1, z3, z5, rhs), z5], dim=-1)

        def grad_of(sol, Cb):
            z1, z3, z5 = sol[:N], sol[N:2 * N], sol[2 * N:]
            f1, f3, f5 = form.dF(z1, z3, z5)
            r4 = Cb[i3:i4]
            return 2.0 * torch.cat([Cb[:i1] + f1 * r4, Cb[i2:i3] + f3 * r4,
                                    Cb[i4:] + f5 * r4])

        def hess_of(sol, Cb):
            z1, z3, z5 = sol[:N], sol[N:2 * N], sol[2 * N:]
            fs = form.dF(z1, z3, z5)
            d2 = form.d2F_contraction(Cb[i3:i4], z1, z3, z5)
            rows = []
            for a in range(3):
                ra0, ra1 = grp_rows[a]
                row = []
                for bg in range(3):
                    rb0, rb1 = grp_rows[bg]
                    blk = (
                        C[ra0:ra1, rb0:rb1]
                        + fs[a][:, None] * C[i3:i4, rb0:rb1]
                        + C[ra0:ra1, i3:i4] * fs[bg][None, :]
                        + fs[a][:, None] * C44 * fs[bg][None, :]
                    )
                    if (a, bg) in d2:
                        blk = blk + torch.diag(d2[(a, bg)])
                    row.append(blk)
                rows.append(torch.cat(row, dim=1))
            return 2.0 * torch.cat(rows, dim=0)

        def losses_of(sols):  # (k, 3N) -> (k,)
            B = b_of(sols)
            return torch.sum((B @ C) * B, dim=1)

        eye = torch.eye(3 * N, dtype=torch.float32, device=dev)
        alphas = 0.5 ** torch.arange(8, dtype=torch.float32, device=dev)
        sol = sol0
        J = losses_of(sol[None, :])[0]
        hist = torch.zeros((steps + 1,), dtype=torch.float32, device=dev)
        hist[0] = J
        done = torch.zeros((), dtype=torch.bool, device=dev)
        gnorm_last = torch.zeros((), dtype=torch.float32, device=dev)
        damp = torch.full((), damping, dtype=torch.float32, device=dev)

        for step in range(steps):
            b = b_of(sol)
            Cb = C @ b
            grad = grad_of(sol, Cb)
            gnorm = torch.linalg.vector_norm(grad)
            stop = done | (gnorm < grad_tol)
            H = hess_of(sol, Cb) + damp * eye
            direction = torch.linalg.solve_ex(H, -grad[:, None])[0][:, 0]
            cand = sol[None, :] + alphas[:, None] * direction[None, :]
            losses = losses_of(cand)
            best = torch.argmin(losses).reshape(1)
            best_loss = losses.index_select(0, best)[0]
            improved = best_loss < J
            accept = improved & ~stop
            sol = torch.where(accept, cand.index_select(0, best)[0], sol)
            J = torch.where(accept, best_loss, J)
            damp = torch.where(improved, torch.clamp_min(damp * 0.1, damping),
                               torch.clamp_max(damp * 10.0, 1.0))
            hist[step + 1] = J
            gnorm_last = torch.where(done, gnorm_last, gnorm)
            done = stop

        right_vector = C @ b_of(sol)
        return _TrainOut(sol=sol, right_vector=right_vector, loss_history=hist,
                         grad_norm=gnorm_last)

    # ------------------------------------------------------------------- eval
    def _require_state(self):
        if self.state is None:
            raise RuntimeError("GP not trained; call GPsolver first.")

    def posterior_u(self, params: GPState, x_t, want_grad: bool = False,
                    want_ops: bool = False):
        """Posterior of a trained state at x_t: (u, grad, dt/div/lap)."""
        x = torch.as_tensor(x_t, dtype=torch.float32, device=params.x_dom.device)
        return posterior_eval(
            x, params.x_dom, params.x_bdy, params.right_vector, params.gamma,
            self.d, want_grad=want_grad, want_ops=want_ops,
            chunk=self.eval_chunk,
            fused=params.fused_inputs() if x.is_cuda else None,
        )

    def residual_u(self, params: GPState, x_t) -> torch.Tensor:
        """Strong-form PDE residual of the posterior mean, shape (n, 1)."""
        x = torch.as_tensor(x_t, dtype=torch.float32, device=params.x_dom.device)
        out = self.posterior_u(params, x, want_ops=True)
        return self.form.residual(x, out.u, out.dt_u, out.div_u, out.lap_u)[:, None]

    def predict(self, x_t_infer) -> torch.Tensor:
        """Posterior mean, shape (n, 1)."""
        self._require_state()
        return self.posterior_u(self.state, x_t_infer).u[:, None]

    def compute_gradient(self, x_t_infer, sol_infer=None) -> torch.Tensor:
        """Full space-time posterior gradient, shape (n, d+1)."""
        self._require_state()
        return self.posterior_u(self.state, x_t_infer, want_grad=True).grad

    def compute_PDE_loss(self, x_t_infer) -> torch.Tensor:
        """Strong-form PDE residual of the posterior mean, shape (n, 1)."""
        self._require_state()
        return self.residual_u(self.state, x_t_infer)


class GPGradDependentNonlinear(GP):
    """GP surrogate for GradDependentNonlinear."""

    form_cls = GradDependentForm
