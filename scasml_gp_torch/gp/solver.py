"""Gaussian-process PDE surrogate: damped-Newton training and evaluation.

Port of ``scasml_gp_tpu/gp/solver.py``.  The loss is

    loss(sol) = b(sol)^T (K + nugget I)^{-1} b(sol),
    b = [z1, g_bdy, z3, F(z1, z3, z5), z5],

minimised by damped Newton with the analytic Hessian, an 8-way backtracking
line search and the reference's damping schedule.  (K + nugget I)^{-1} is
formed once, so each step is matrix products, one 3N x 3N solve and
elementwise work.  The step loop is a Python loop whose stop/accept/damping
state stays in device tensors: it makes no host sync.  Past
``GPConfig.dense_phi_max`` training goes to the dual-CG trainer of
gp/distributed.py instead.

``PrecisionPolicy.gram = 'bfloat16'`` computes the Gram's and the
posterior's pair statistics from bf16-rounded points.  The parity modes
(``laplacian='subset'``, ``parity_fp16``; gp/parity.py) train on the
reference's biased Gram through its fp64 pseudo-Cholesky and evaluate its
biased cross-kernels.  A ``mesh`` (parallel/mesh.py) with more than one
'model' rank assembles the Gram by row blocks over that axis and splits the
posterior's training rows over it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from scasml_gp_torch.config import GPConfig, PrecisionPolicy
from scasml_gp_torch.equations.base import Equation
from scasml_gp_torch.gp.gram import (
    gram_matrix,
    regularized_factorization,
    sharded_gram_matrix,
)
from scasml_gp_torch.gp.kernels import kernel_gammas
from scasml_gp_torch.gp.posterior import posterior_eval
from scasml_gp_torch.gp.state import GPState
from scasml_gp_torch.gp.variance import factor_for_variance, posterior_variance
from scasml_gp_torch.utils.device import resolve_device


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


class AllenCahnForm(GPForm):
    """Allen-Cahn (mu = 0): F = -(sigma^2/2) z3 - (z1 - z1^3) + rhs."""

    def F(self, z1, z3, z5, rhs):
        sig2 = self.equation.sigma() ** 2
        return -(sig2 / 2.0) * z3 - (z1 - z1**3) + rhs

    def dF(self, z1, z3, z5):
        sig2 = self.equation.sigma() ** 2
        return (-(1.0 - 3.0 * z1 * z1), -(sig2 / 2.0) * torch.ones_like(z1),
                torch.zeros_like(z1))

    def d2F_contraction(self, w, z1, z3, z5):
        return {(0, 0): 6.0 * z1 * w}

    def residual(self, x, u, dt_u, div_u, lap_u):
        sig2 = self.equation.sigma() ** 2
        return dt_u + (sig2 / 2.0) * lap_u + (u - u**3)


class SineForm(GPForm):
    """SineNonlinear, the one family with a nonzero ``rhs_f``:
    F = -(mu + sigma/d) z5 - (sigma^2/2) z3 - sin(z1) + rhs, rhs = -R(x)."""

    def rhs_f(self, x_dom):
        return (-self.equation.forcing(x_dom)).to(torch.float32)

    def F(self, z1, z3, z5, rhs):
        eq = self.equation
        sig = eq.sigma()
        c5 = eq.mu() + sig / eq.dim
        return -c5 * z5 - (sig**2 / 2.0) * z3 - torch.sin(z1) + rhs

    def dF(self, z1, z3, z5):
        eq = self.equation
        sig = eq.sigma()
        ones = torch.ones_like(z1)
        return (-torch.cos(z1), -(sig**2 / 2.0) * ones,
                -(eq.mu() + sig / eq.dim) * ones)

    def d2F_contraction(self, w, z1, z3, z5):
        return {(0, 0): torch.sin(z1) * w}

    def residual(self, x, u, dt_u, div_u, lap_u):
        eq = self.equation
        sig = eq.sigma()
        return (dt_u + (eq.mu() + sig / eq.dim) * div_u
                + (sig**2 / 2.0) * lap_u + torch.sin(u) + eq.forcing(x))


class _TrainOut(NamedTuple):
    sol: torch.Tensor
    right_vector: torch.Tensor
    loss_history: torch.Tensor
    grad_norm: torch.Tensor


class GP:
    """Gaussian kernel PDE solver; subclass with a GPForm per equation."""

    form_cls = None

    def __init__(self, equation: Equation, config: Optional[GPConfig] = None,
                 precision: Optional[PrecisionPolicy] = None, device=None,
                 mesh=None):
        from scasml_gp_torch.parallel.mesh import check_mesh

        self.equation = equation
        self.config = config or GPConfig()
        self.precision = precision or PrecisionPolicy()
        self.device = resolve_device(device)
        # training rows split over the mesh's 'model' axis (parallel/mesh.py)
        self.mesh = check_mesh(mesh)
        cfg = self.config
        if cfg.laplacian not in ("exact", "subset"):
            raise ValueError(
                f"unknown laplacian mode {cfg.laplacian!r}; "
                "use 'exact' (closed form) or 'subset' (reference-parity "
                "frozen-subset Hutchinson, gp/parity.py)."
            )
        if cfg.posterior_backend not in ("auto", "xla"):
            raise ValueError(f"unknown posterior backend {cfg.posterior_backend!r}")
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
        self._subset = None
        self._posterior = posterior_eval
        if cfg.laplacian == "subset":
            if cfg.time_scale != 1.0 or cfg.ridge_scale != 0.0 or cfg.gamma_scale != 1.0:
                raise ValueError(
                    "parity mode (laplacian='subset') requires the reference's "
                    "isotropic kernel: time_scale=1, ridge_scale=0, "
                    "gamma_scale=1."
                )
            from scasml_gp_torch.gp.parity import make_parity_posterior, subset_indices

            self._subset = subset_indices(self.d, cfg.laplacian_subset_size)
            self._posterior = make_parity_posterior(self._subset, cfg.parity_fp16)

    @property
    def parity(self) -> bool:
        """Whether a parity mode (``laplacian='subset'`` or ``parity_fp16``)
        is on."""
        return self.config.laplacian == "subset" or self.config.parity_fp16

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
        if self._resolve_train_backend(x_dom, x_bdy) == "distributed":
            if sol0 is not None:
                raise ValueError("sol0 is the dense trainer's initial point; the "
                                 "distributed trainer starts from zero")
            return self._gpsolver_distributed(x_dom, x_bdy, GN_steps)
        bdy_g = self.equation.g(x_bdy)[:, 0].to(torch.float32)
        rhs = self.form.rhs_f(x_dom).to(torch.float32)
        gamma = torch.tensor(self.gamma, dtype=torch.float32, device=self.device)
        if self.parity:
            out = self._train_parity(x_dom, x_bdy, bdy_g, rhs, steps, sol0)
        else:
            out = self._train(x_dom, x_bdy, bdy_g, rhs, gamma, self.nugget, steps,
                              cfg.damping, cfg.grad_tol, sol0)
        self.state = GPState(
            x_dom=x_dom, x_bdy=x_bdy, right_vector=out.right_vector,
            sol=out.sol, gamma=gamma, loss_history=out.loss_history,
        )
        self.loss_history = out.loss_history
        return self.predict(x_dom)

    def _resolve_train_backend(self, x_dom, x_bdy) -> str:
        """'dense' or 'distributed' per ``config.train_backend``: 'auto'
        takes the dual-CG trainer (gp/distributed.py) once phi = 4N + Nb
        exceeds ``dense_phi_max``."""
        cfg = self.config
        backend = cfg.train_backend
        if backend == "auto":
            phi = 4 * x_dom.shape[0] + x_bdy.shape[0]
            backend = "distributed" if phi > cfg.dense_phi_max else "dense"
        if backend not in ("dense", "distributed"):
            raise ValueError(f"unknown train_backend {cfg.train_backend!r}")
        if backend == "distributed" and (cfg.laplacian != "exact" or cfg.parity_fp16):
            raise ValueError(
                "the distributed trainer supports only the exact-Laplacian "
                "fp32 kernel (no parity modes)"
            )
        return backend

    def _gpsolver_distributed(self, x_dom, x_bdy,
                              GN_steps: Optional[int] = None) -> torch.Tensor:
        """Large-N training through the dual-CG trainer; an explicit
        ``GN_steps`` (ComputingBudget's budget axis) overrides
        ``config.dist_gn_steps``."""
        from scasml_gp_torch.gp.distributed import distributed_gpsolver

        cfg = self.config
        steps = cfg.dist_gn_steps if GN_steps is None else int(GN_steps)
        distributed_gpsolver(self, x_dom, x_bdy, self.mesh, gn_steps=steps,
                             cg_tol=cfg.dist_cg_tol, cg_maxiter=cfg.dist_cg_maxiter)
        self.loss_history = self.state.loss_history
        return self.predict(x_dom)

    def _train(self, x_dom, x_bdy, bdy_g, rhs, gamma, nugget, steps, damping,
               grad_tol, sol0: Optional[torch.Tensor] = None,
               mesh=None) -> _TrainOut:
        """The dense Newton train for kernel precisions ``gamma`` (3,) and
        ``nugget``, shared by ``GPsolver`` and the tuner's candidates.
        ``sol0`` (3N,) is the initial point; None draws it from a generator
        seeded with 0, times ``config.init_scale``.  With a ``mesh`` (by
        default the GP's) of more than one 'model' rank the Gram is
        assembled by row blocks over that axis; the factorization and the
        Newton steps run on every rank."""
        sol0 = self._initial_point(x_dom.shape[0], x_dom.device, sol0)
        mesh = self.mesh if mesh is None else mesh
        od = self.precision.gram_dtype
        if mesh is not None and mesh.model > 1:
            K = sharded_gram_matrix(x_dom, x_bdy, gamma, self.d, mesh, od)
        else:
            K = gram_matrix(x_dom, x_bdy, gamma, self.d, od)
        _, C = regularized_factorization(K, nugget)
        del K
        return self._newton_body(C, bdy_g, rhs, steps, damping, grad_tol, sol0)

    def _initial_point(self, N: int, dev, sol0=None) -> torch.Tensor:
        """``sol0`` checked, or the Newton train's initial point drawn from a
        generator seeded with 0, times ``config.init_scale``."""
        if sol0 is None:
            gen = torch.Generator(device=dev).manual_seed(0)
            sol0 = torch.randn((3 * N,), generator=gen, device=dev) * self.config.init_scale
        sol0 = torch.as_tensor(sol0, dtype=torch.float32, device=dev)
        if sol0.shape != (3 * N,):
            raise ValueError(f"sol0 must have shape ({3 * N},), got {tuple(sol0.shape)}")
        return sol0

    def _train_parity(self, x_dom, x_bdy, bdy_g, rhs, steps,
                      sol0: Optional[torch.Tensor] = None) -> _TrainOut:
        """The parity train: the biased subset-Laplacian Gram (gp/parity.py)
        and/or its fp16 quantization, factored by the reference's fp64
        pseudo-Cholesky, then the same Newton steps on that C (the JAX
        package's ``_train_from_C``)."""
        from scasml_gp_torch.gp.parity import parity_factorization, parity_gram_matrix

        cfg = self.config
        fp16 = cfg.parity_fp16
        if cfg.laplacian == "subset":
            K = parity_gram_matrix(x_dom, x_bdy, float(self.gamma[0]), self._subset,
                                   self.d, fp16)
        else:  # the exact closed-form blocks, fp16-quantized
            gamma = torch.tensor(self.gamma, dtype=torch.float32, device=x_dom.device)
            K = gram_matrix(x_dom, x_bdy, gamma, self.d)
            if fp16:
                K = K.to(torch.float16).to(torch.float32)
        _, C = parity_factorization(K, self.nugget, fp16)
        del K
        return self._newton_body(C, bdy_g, rhs, steps, cfg.damping, cfg.grad_tol,
                                 self._initial_point(x_dom.shape[0], x_dom.device, sol0))

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
        """Posterior of a trained state at x_t: (u, grad, dt/div/lap), with
        the policy's operand dtype and the mesh's 'model' axis."""
        x = torch.as_tensor(x_t, dtype=torch.float32, device=params.x_dom.device)
        shard = self._dom_sharding()
        fused = None
        if not self.parity and (x.is_cuda or shard is not None):
            fused = params.fused_inputs(self.precision.gram_dtype, shard)
        return self._posterior(
            x, params.x_dom, params.x_bdy, params.right_vector, params.gamma,
            self.d, want_grad=want_grad, want_ops=want_ops,
            chunk=self.eval_chunk, operand_dtype=self.precision.gram,
            shard_dom=shard, fused=fused,
        )

    def _dom_sharding(self):
        """The mesh when its 'model' axis has more than one rank (the
        posterior then splits its training rows over it), else None."""
        if self.mesh is None or self.mesh.model <= 1:
            return None
        return self.mesh

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

    def predict_std(self, x_t_infer) -> torch.Tensor:
        """Posterior standard deviation of the collocation model, shape
        (n, 1) (gp/variance.py).  The (K + nugget I)^{-1} factor is rebuilt
        once per trained state and cached on the instance."""
        self._require_state()
        st = self.state
        if getattr(self, "_var_cache_for", None) is not st:
            self._var_C = factor_for_variance(st.x_dom, st.x_bdy, st.gamma,
                                              self.nugget, self.d,
                                              self.precision.gram_dtype)
            self._var_cache_for = st
        x = torch.as_tensor(x_t_infer, dtype=torch.float32, device=st.x_dom.device)
        var = posterior_variance(x, st.x_dom, st.x_bdy, self._var_C, st.gamma,
                                 self.d, chunk=self.eval_chunk,
                                 operand_dtype=self.precision.gram_dtype)
        return torch.sqrt(var)[:, None]

    def predict_with_std(self, x_t_infer):
        """(posterior mean, posterior std), each shape (n, 1)."""
        return self.predict(x_t_infer), self.predict_std(x_t_infer)


class GPGradDependentNonlinear(GP):
    """GP surrogate for GradDependentNonlinear."""

    form_cls = GradDependentForm


class GPAllenCahn(GP):
    """Space-time collocation GP for AllenCahn (the runner uses the
    reaction-semigroup surrogate, gp/semigroup.py, instead)."""

    form_cls = AllenCahnForm


class GPSineNonlinear(GP):
    """GP surrogate for SineNonlinear."""

    form_cls = SineForm
