"""Gaussian-process PDE surrogate: damped-Newton training and evaluation.

Port of ``scasml_gp_tpu/gp/solver.py``.  The loss is

    loss(sol) = b(sol)^T (K + nugget I)^{-1} b(sol),
    b = [z1, g_bdy, z3, F(z1, z3, z5), z5],

minimised by damped Newton with the analytic Hessian, an 8-way backtracking
line search and the reference's damping schedule.  (K + nugget I)^{-1} is
formed once, so each step is matrix products, one 3N x 3N solve and
elementwise work; a step's gradient and Newton matrix come from C's rows at
the unknowns, gathered once a train (``_unknowns_rows``), one broadcast a
term.  The step loop is a Python loop whose stop/accept/damping
state stays in device tensors.  The Newton matrix is symmetric, and positive
definite in most steps, so each step factors it by Cholesky
(``PendingSolve``) and copies the factorization's flag vector (a matrix's
``info``) to pinned host memory without waiting.  In a single train the
host reads step k's flags only once step k's line search and step k+1's
Hessian are queued, so the card has work while it waits; where potrf
failed, step k's line search runs again from the LU directions and step
k+1's Hessian is rebuilt (the discarded work runs and is dropped).
Every accepted path runs the same operations as reading the flags at once
(``spd_first_solve``), so the train is bitwise the same.  The last step,
and every step of a batch of restarts, reads at once.  The parity modes
solve every step by pivoted LU, as the reference does, and never defer.
Elsewhere a matrix that potrf refuses is solved by LU without pivoting of
its Jacobi-scaled form (``nopivot_solve``), whose answer is kept where its
backward error passes a gate, else by pivoted LU.
Past ``GPConfig.dense_phi_max`` training goes to the dual-CG trainer of
gp/distributed.py instead.

A train's stretches are spans (utils/profiling.py): ``train.gram``,
``train.factor``, ``train.newton`` around the step loop, inside it each
step's 3N x 3N solve ``train.newton_solve`` and within that the LU
fallback ``train.newton_lu``, and ``train.answer`` (the closing posterior
mean).  ``GP.newton_solves`` and ``GP.newton_lu_fallbacks`` count the
matrices the Cholesky-first solve took and those it handed to LU, and
``GP.newton_nopivot_solves`` and ``GP.newton_pivoted_solves`` split the
latter into those the no-pivot LU's gate accepted and those it rejected;
``GP.newton_deferred_reads`` the steps whose flags were read behind the next
step's Hessian, and ``GP.newton_redos`` those of them redone because potrf
failed.

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
    per_matrix,
    regularized_factorization,
    sharded_gram_matrix,
)
from scasml_gp_torch.gp.kernels import kernel_gammas
from scasml_gp_torch.gp.posterior import posterior_eval
from scasml_gp_torch.gp.state import GPState
from scasml_gp_torch.gp.variance import factor_for_variance, posterior_variance
from scasml_gp_torch.utils.device import resolve_device
from scasml_gp_torch.utils.profiling import span


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


# a no-pivot LU answer X of H X = B is kept when its backward error
# |H X - B| / (|H|_F |X| + |B|), in float32, is at most this: about 40x the
# worst either LU read on the Newton matrices of the train cell that potrf
# refused (PERF.md §6)
NOPIVOT_BACKWARD_ERROR = 1e-7


class _HostFlags:
    """A small device tensor copied to pinned host memory without waiting,
    with an event behind the copy; ``read()`` waits for the event only.  On
    the CPU the tensor itself."""

    def __init__(self, flags: torch.Tensor):
        self._ready = None
        if flags.is_cuda:
            # the copy runs on the stream of the flags' card, which need not
            # be the current one (a mesh rank trains on cuda:<LOCAL_RANK>):
            # the event goes behind it there
            with torch.cuda.device(flags.device):
                self._host = torch.empty(flags.shape, dtype=flags.dtype, pin_memory=True)
                self._host.copy_(flags, non_blocking=True)
                self._ready = torch.cuda.Event()
                self._ready.record()
        else:
            self._host = flags

    def read(self) -> list:
        if self._ready is not None:
            self._ready.synchronize()
        return self._host.reshape(-1).tolist()


def _lu_nopivot_cpu(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(LU, info) of A (n, n) by LU without pivoting, in LAPACK's packed
    form (unit L below the diagonal, U on and above it) and with its
    ``info`` (1 + the first zero pivot's index, else 0): a blocked
    right-looking LU for the CPU, where ``lu_factor``'s ``pivot=False``
    does not exist."""
    LU = A.clone()
    n, block = LU.shape[-1], 64
    for k in range(0, n, block):
        e = min(k + block, n)
        for j in range(k, e):  # the panel, column by column
            LU[j + 1:, j] /= LU[j, j]
            LU[j + 1:, j + 1:e] -= LU[j + 1:, j, None] * LU[j, j + 1:e]
        if e < n:
            LU[k:e, e:] = torch.linalg.solve_triangular(LU[k:e, k:e], LU[k:e, e:],
                                                        upper=False, unitriangular=True)
            LU[e:, e:] -= LU[e:, k:e] @ LU[k:e, e:]
    zero = LU.diagonal() == 0
    info = torch.where(zero.any(), zero.int().argmax() + 1, 0).int()
    return LU, info


def nopivot_solve(A: torch.Tensor, B: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(X, accepted) for A (n, n) and B (n, k), computed on A's device
    without waiting: X = S Y with (S A S) Y = S B solved by LU without
    pivoting, S = |diag A|^-1/2 (Jacobi scaling), and ``accepted`` a bool
    tensor: getrf's ``info`` is 0, X is finite and its backward error is at
    most ``NOPIVOT_BACKWARD_ERROR``.  On the card the LU is cuSOLVER's getrf
    without pivots (``lu_factor_ex(pivot=False)``); on the CPU
    ``_lu_nopivot_cpu``."""
    s = torch.rsqrt(torch.clamp_min(A.diagonal().abs(), torch.finfo(A.dtype).tiny))
    As = s[:, None] * A * s
    if A.device.type == "cpu":
        LU, info = _lu_nopivot_cpu(As)
    else:
        LU, _, info = torch.linalg.lu_factor_ex(As, pivot=False)
    Y = torch.linalg.solve_triangular(LU, s[:, None] * B, upper=False, unitriangular=True)
    X = s[:, None] * torch.linalg.solve_triangular(LU, Y, upper=True)
    norm = torch.linalg.vector_norm
    error = norm(A @ X - B) / (norm(A) * norm(X) + norm(B))
    return X, (info == 0) & torch.isfinite(X).all() & (error <= NOPIVOT_BACKWARD_ERROR)


class PendingSolve:
    """A Cholesky-first solve of A X = B whose flags the host has not read:
    for a symmetric A (n, n) and B (n, k), or a batch A (R, n, n) and B
    (R, n, k), every matrix's potrf, a copy of the factorizations' ``info``
    to pinned host memory with an event behind it, and every potrs are
    queued, one call per matrix (``per_matrix`` says why); nothing waits.
    ``X`` holds the Cholesky answers; ``result()`` reads the flags."""

    def __init__(self, A: torch.Tensor, B: torch.Tensor):
        self.A, self.B = A, B
        L, info = per_matrix(torch.linalg.cholesky_ex, A)
        self._info = _HostFlags(info)
        self.X = per_matrix(torch.cholesky_solve, B, L)

    def result(self) -> Tuple[torch.Tensor, int, int]:
        """(X, matrices whose potrf failed, of them those solved by pivoted
        LU): waits for the flags.  A matrix that is not positive definite
        (info != 0) is solved again by ``nopivot_solve``, and the host waits
        once more, for its acceptance; a matrix it rejects is solved by
        pivoted LU, ``torch.linalg.solve_ex``, bitwise what ``solve_ex``
        alone gives it.  Either answer takes the matrix's slot of ``X``."""
        bad = [i for i, flag in enumerate(self._info.read()) if flag]
        X = self.X
        pivoted = 0
        if bad:
            with span("train.newton_lu"):
                if self.A.dim() == 2:
                    X, ok = nopivot_solve(self.A, self.B)
                    if not _HostFlags(ok).read()[0]:
                        X, pivoted = torch.linalg.solve_ex(self.A, self.B)[0], 1
                else:
                    outs = [nopivot_solve(self.A[i], self.B[i]) for i in bad]
                    for i, (x, _) in zip(bad, outs):
                        X[i] = x
                    accepted = _HostFlags(torch.stack([ok for _, ok in outs])).read()
                    for i, ok in zip(bad, accepted):
                        if not ok:
                            X[i] = torch.linalg.solve_ex(self.A[i], self.B[i])[0]
                            pivoted += 1
        return X, len(bad), pivoted


def spd_first_solve(A: torch.Tensor, B: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """(X, matrices whose potrf failed, of them those solved by pivoted LU)
    with A X = B: the ``PendingSolve`` of A and B, its flags read at once."""
    return PendingSolve(A, B).result()


def _lu_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X with A X = B by pivoted LU for every matrix: the parity modes'
    Newton solve, as the reference's ``jnp.linalg.solve``."""
    return per_matrix(torch.linalg.solve_ex, A, B)[0]


def _unknowns_rows(C: torch.Tensor, N: int, Nb: int) -> tuple:
    """Where the unknowns z = (z1, z3, z5) sit among the rows of
    b = [z1, bdy, z3, F, z5], and the rows of C (or of a batch (R, phi, phi))
    that a Newton step reads, gathered once a train: (z, b's rows of F,
    C[z, z], C[z, F], C[F, z], C[F, F]), z (3N,) in sol's order."""
    z = torch.cat([torch.arange(s, s + N, device=C.device) for s in (0, N + Nb, 3 * N + Nb)])
    F = slice(2 * N + Nb, 3 * N + Nb)
    return (z, F, C.index_select(-2, z).index_select(-1, z), C[..., F].index_select(-2, z),
            C[..., F, :].index_select(-1, z), C[..., F, F])


def _newton_system(form: GPForm, rows: tuple, sol: torch.Tensor,
                   Cb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gradient (..., 3N), undamped Newton matrix (..., 3N, 3N)) of
    b(sol)^T C b(sol) at ``sol`` (..., 3N), with Cb = C b(sol) and ``rows``
    from ``_unknowns_rows``.  Block (a, b) is 2 (C_ab + f_a C_Fb + C_aF f_b
    + f_a C_FF f_b + D_ab), f = dF and D the diagonals of
    ``form.d2F_contraction``, each element summed in that order."""
    z, F, Czz, Cz4, C4z, C44 = rows
    lead, N = sol.shape[:-1], sol.shape[-1] // 3
    z1, z3, z5 = sol[..., :N], sol[..., N:2 * N], sol[..., 2 * N:]
    f = torch.cat(form.dF(z1, z3, z5), dim=-1).view(lead + (3, N))
    r4 = Cb[..., F]
    grad = 2.0 * (Cb.index_select(-1, z) + (f * r4[..., None, :]).flatten(-2))
    H = Czz.unflatten(-2, (3, N)) + f[..., None] * C4z[..., None, :, :]
    H.view(lead + (3 * N, 3, N)).add_(Cz4[..., None, :] * f[..., None, :, :])
    H = H.view(lead + (3, N, 3, N))
    H.add_((f[..., None, None] * C44[..., None, :, None, :]) * f[..., None, None, :, :])
    for (a, b), w in form.d2F_contraction(r4, z1, z3, z5).items():
        H[..., a, :, b, :].diagonal(dim1=-2, dim2=-1).add_(w)
    return grad, 2.0 * H.view(lead + (3 * N, 3 * N))


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
        # matrices the dense trainer's Newton steps solved, and of them those
        # that were not positive definite and went to LU
        self.newton_solves = 0
        self.newton_lu_fallbacks = 0
        # of the fallbacks, those the no-pivot LU's gate accepted, and those
        # it sent to pivoted LU (``PendingSolve.result``)
        self.newton_nopivot_solves = 0
        self.newton_pivoted_solves = 0
        # steps whose flags were read behind the next step's Hessian, and of
        # them those redone because potrf failed
        self.newton_deferred_reads = 0
        self.newton_redos = 0
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
        with span("train.answer"):
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
        Newton steps run on every rank.

        ``gamma`` (R, 3) and ``nugget`` (R,) train R kernels at once, every
        one from the same ``sol0``, as the JAX package's vmapped
        ``_train_jit`` does (the marginal-likelihood fit's restarts); the
        outputs gain a leading axis R."""
        sol0 = self._initial_point(x_dom.shape[0], x_dom.device, sol0)
        mesh = self.mesh if mesh is None else mesh
        od = self.precision.gram_dtype
        with span("train.gram"):
            if mesh is not None and mesh.model > 1:
                K = sharded_gram_matrix(x_dom, x_bdy, gamma, self.d, mesh, od)
            else:
                K = gram_matrix(x_dom, x_bdy, gamma, self.d, od)
        with span("train.factor"):
            _, C = regularized_factorization(K, nugget)
        del K
        return self._newton_body(C, bdy_g, rhs, steps, damping, grad_tol, sol0,
                                 self._newton_solve)

    def _newton_solve(self, H: torch.Tensor, B: torch.Tensor) -> PendingSolve:
        """The Cholesky-first solve, queued, counted in ``newton_solves``;
        ``_newton_body`` reads its flags and counts the fallbacks."""
        self.newton_solves += 1 if H.dim() == 2 else H.shape[0]
        return PendingSolve(H, B)

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
                                 self._initial_point(x_dom.shape[0], x_dom.device, sol0),
                                 _lu_solve)

    def _newton_body(self, C, bdy_g, rhs, steps, damping, grad_tol,
                     sol0, solve) -> _TrainOut:
        """Damped Newton from ``sol0`` on (K + nugget I)^{-1} = C, which may
        be a batch (R, phi, phi): each restart then takes its own line
        search, damping and stop, and the outputs gain the axis R.
        ``solve(H, B)`` solves each step's Newton system H X = B and returns
        X, or a ``PendingSolve``: for one train step k's flags are then
        read after step k's line search and step k+1's Hessian are queued,
        and where potrf failed both are computed again from the state before
        the line search (the last step reads at once).  A batch reads each
        step's flags at once: one restart's failed potrf would redo every
        restart's line search and Hessian, and the batch's kernels keep the
        card busy while the host launches them (PERF.md §6).  Either way the
        train is the one that reading the flags at once gives."""
        N = rhs.shape[0]
        Nb = bdy_g.shape[0]
        dev = C.device
        batch = C.shape[:-2]
        rows = _unknowns_rows(C, N, Nb)
        form = self.form

        def b_of(sol):  # sol (..., 3N) -> b (..., phi)
            z1, z3, z5 = sol[..., :N], sol[..., N:2 * N], sol[..., 2 * N:]
            g = bdy_g.expand(sol.shape[:-1] + (Nb,))
            return torch.cat([z1, g, z3, form.F(z1, z3, z5, rhs), z5], dim=-1)

        def losses_of(sols):  # (..., k, 3N) -> (..., k)
            B = b_of(sols)
            return torch.sum((B @ C) * B, dim=-1)

        eye = torch.eye(3 * N, dtype=torch.float32, device=dev)
        alphas = 0.5 ** torch.arange(8, dtype=torch.float32, device=dev)
        sol = sol0.expand(batch + sol0.shape)
        J = losses_of(sol[..., None, :])[..., 0]
        hist = torch.zeros(batch + (steps + 1,), dtype=torch.float32, device=dev)
        hist[..., 0] = J
        done = torch.zeros(batch, dtype=torch.bool, device=dev)
        gnorm_last = torch.zeros(batch, dtype=torch.float32, device=dev)
        damp = torch.full(batch, damping, dtype=torch.float32, device=dev)
        state = (sol, J, damp, done, gnorm_last)

        def system(state):
            """A step's Newton matrix, gradient, gradient norm and stop flags."""
            sol, _, damp, done, _ = state
            Cb = per_matrix(torch.mv, C, b_of(sol))
            grad, H = _newton_system(form, rows, sol, Cb)
            gnorm = torch.linalg.vector_norm(grad, dim=-1)
            stop = done | (gnorm < grad_tol)
            return H + damp[..., None, None] * eye, grad, gnorm, stop

        def advance(step, state, gnorm, stop, X):
            """The state after ``step``'s line search along the directions X
            (..., 3N, 1), which writes its loss into ``hist``."""
            sol, J, damp, done, gnorm_last = state
            cand = sol[..., None, :] + alphas[:, None] * X[..., None, :, 0]
            losses = losses_of(cand)
            best = torch.argmin(losses, dim=-1, keepdim=True)
            best_loss = losses.gather(-1, best)[..., 0]
            best_sol = cand.gather(-2, best[..., None].expand(batch + (1, 3 * N)))[..., 0, :]
            improved = best_loss < J
            accept = improved & ~stop
            sol = torch.where(accept[..., None], best_sol, sol)
            J = torch.where(accept, best_loss, J)
            damp = torch.where(improved, torch.clamp_min(damp * 0.1, damping),
                               torch.clamp_max(damp * 10.0, 1.0))
            hist[..., step + 1] = J
            gnorm_last = torch.where(done, gnorm_last, gnorm)
            return sol, J, damp, stop, gnorm_last

        def read(pending):
            """A PendingSolve's X, and whether potrf failed for any matrix."""
            X, n_lu, pivoted = pending.result()
            self.newton_lu_fallbacks += n_lu
            self.newton_nopivot_solves += n_lu - pivoted
            self.newton_pivoted_solves += pivoted
            return X, n_lu > 0

        with span("train.newton"):
            # the previous step's (state before its line search, gradient
            # norm, stop flags, PendingSolve) while its flags are unread
            late = None
            for step in range(steps):
                H, grad, gnorm, stop = system(state)
                with span("train.newton_solve"):
                    if late is not None:
                        before, late_gnorm, late_stop, pending = late
                        late = None
                        self.newton_deferred_reads += 1
                        X, failed = read(pending)
                        if failed:  # the last step again, from its LU directions
                            self.newton_redos += 1
                            state = advance(step - 1, before, late_gnorm, late_stop, X)
                            H, grad, gnorm, stop = system(state)
                    X = solve(H, -grad[..., :, None])
                    if isinstance(X, PendingSolve):
                        if step + 1 < steps and not batch:
                            late, X = (state, gnorm, stop, X), X.X
                        else:  # a batch, or no next Hessian to read behind
                            X, _ = read(X)
                state = advance(step, state, gnorm, stop, X)
        sol, gnorm_last = state[0], state[4]

        right_vector = per_matrix(torch.mv, C, b_of(sol))
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
