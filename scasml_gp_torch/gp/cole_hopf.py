"""Cole-Hopf semigroup GP surrogate for the HJB equation.

Port of ``scasml_gp_tpu/gp/cole_hopf.py``.  With k = 2/sigma^2 and
v = exp(-k u), the HJB equation u_t + (sigma^2/2) Lap u - |grad u|^2 = 0
becomes the linear backward heat equation v_t + (sigma^2/2) Lap v = 0 with
v(x, T) = exp(-k g(x)), and the heat semigroup acts on Gaussians in closed
form.  Two terminal representations:

- ``rbf``: a constant-mean Gaussian-RBF interpolant of v_T on centers pushed
  to t = T along each training point's diffusion cone; each bump widens
  s^2 -> s^2 + sigma^2 tau under the flow (one m x m Cholesky to fit);
- ``mixture``: v_T = a^k (1 + b|x|^2)^{-k} is an exact mixture of
  origin-centered Gaussians (Bernstein), evolved by
  :func:`scasml_gp_torch.gp.semigroup.mixture_features` (no fit).

Every u-space quantity is closed-form (u = -ln(v)/k, grad u = -grad v/(k v),
...), and the u-space PDE residual is identically zero, so ScaSML's leaf
injection vanishes and its rollout corrects only the terminal-fit error.
Evaluation is plain PyTorch: one (n, m) distance product, fused elementwise
bump math and one (n, m) @ (m, d) product, as the JAX package left it to
XLA.  The surrogate never reaches the fused posterior kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from scasml_gp_torch.gp.posterior import PosteriorOut
from scasml_gp_torch.gp.solver import GP
from scasml_gp_torch.gp.state import GPState

# The default seed of the rbf centers' pushes (GPsolver).  It must not be a
# seed the Picard solvers' generators take (0 by default, small integers in
# practice): a solver seeded like the centers draws the same normals, its
# first paths then replay the pushes onto the centers, where the fit is
# exact, and the ScaSML correction comes out biased (the coarse HJB leg at
# d=250: 0.036-0.039 rel-L2 where independent streams give 0.012-0.014).
# The JAX package draws the centers from PRNGKey(0) and the solvers from its
# splits, which never meet.
CENTRE_SEED = 0x2545F4914F6CDD1D


def _v_block(x, y, alpha, s, mbar, sig2, T, dim, want_grad, want_ops):
    """Semigroup-evolved kernel regression at rows x (n, d+1), time last:
    v = mbar + sum_j alpha_j (s^2/w)^{d/2} exp(-|x - y_j|^2 / 2w),
    w = s^2 + sig2 (T - t).  Returns (v, grad_sp_v, dt_v, div_v, lap_v);
    the derivative entries are None unless requested.  y: (m, d)."""
    xs = x[:, :dim]
    tau = torch.clamp_min(T - x[:, dim], 0.0)
    w = s * s + sig2 * tau
    c = (s * s / w) ** (dim / 2.0)
    d2 = (torch.sum(xs * xs, dim=1)[:, None] + torch.sum(y * y, dim=1)[None, :]
          - 2.0 * xs @ y.T)
    d2 = torch.clamp_min(d2, 0.0)
    phi = alpha[None, :] * torch.exp(-d2 / (2.0 * w[:, None]))
    phi_sum = torch.sum(phi, dim=1)
    v_bumps = c * phi_sum
    v = mbar + v_bumps

    grad_sp = dt_v = div_v = lap_v = None
    if want_grad or want_ops:
        # grad_x v = -c/w sum_j phi_j (x - y_j); mbar is constant
        grad_sp = -(c / w)[:, None] * (phi_sum[:, None] * xs - phi @ y)
    if want_ops:
        lap_v = c * torch.sum(phi * (d2 / (w * w)[:, None]), dim=1) - dim * v_bumps / w
        dt_v = -(sig2 / 2.0) * lap_v                # exact: v solves the PDE
        div_v = torch.sum(grad_sp, dim=1)
    return v, grad_sp, dt_v, div_v, lap_v


def chunked(block, x, chunk: Optional[int]):
    """block(x) over row chunks of at most ``chunk``, outputs concatenated
    (None entries stay None)."""
    n = x.shape[0]
    if chunk is None or n <= chunk:
        return block(x)
    parts = [block(x[i: i + chunk]) for i in range(0, n, chunk)]
    return tuple(None if vals[0] is None else torch.cat(vals, dim=0)
                 for vals in zip(*parts))


def sq_dists(y: torch.Tensor) -> torch.Tensor:
    """(m, m) squared distances |y_i - y_j|^2, clamped at 0."""
    n2 = torch.sum(y * y, dim=1)
    return torch.clamp_min(n2[:, None] + n2[None, :] - 2.0 * y @ y.T, 0.0)


def terminal_fit(d2, targets, width: float, nugget: float):
    """Constant-mean RBF interpolant of ``targets`` on centers with squared
    distances d2: (alpha, mbar, fit_rms) from one m x m Cholesky of
    K + nugget I, K = exp(-d2 / (2 width^2)).  The constant prior mean is a
    heat-semigroup fixed point, so the evolved interpolant still solves the
    PDE exactly."""
    mbar = torch.mean(targets)
    K = torch.exp(-d2 / (2.0 * width**2))
    eye = torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    L = torch.linalg.cholesky(K + nugget * eye)
    alpha = torch.cholesky_solve((targets - mbar)[:, None], L)[:, 0]
    fit_rms = torch.sqrt(torch.mean((mbar + K @ alpha - targets) ** 2))
    return alpha, mbar, fit_rms


def push_to_terminal(x_all, sig2: float, T: float, gen: torch.Generator):
    """Terminal-fit centers (m, d+1) at t = T: each point's spatial part
    moved along its own diffusion cone, x + sigma sqrt(T - t) xi."""
    xs, t = x_all[:, :-1], x_all[:, -1]
    spread = torch.sqrt(sig2 * torch.clamp_min(T - t, 0.0))
    xi = torch.randn(xs.shape, generator=gen, device=gen.device,
                     dtype=xs.dtype).to(xs.device)
    y = xs + spread[:, None] * xi
    return torch.cat([y, torch.full((y.shape[0], 1), T, dtype=y.dtype,
                                    device=y.device)], dim=1)


class TerminalSemigroupGP(GP):
    """Base of the semigroup surrogates (HJB, Allen-Cahn): a terminal
    representation, the exact Bernstein ``mixture`` or a fitted ``rbf``,
    evolved in closed form.  Subclasses set ``sig2`` and implement
    ``_fit_mixture(x_dom)`` and ``_fit_rbf(x_dom, y_t)``."""

    def _set_backend(self, terminal_backend: str, bernstein: str, form: str):
        """Resolve 'auto' to 'mixture' when the equation has the method
        ``bernstein`` (its terminal condition in the closed ``form``), else
        to 'rbf'."""
        has = getattr(self.equation, bernstein, None) is not None
        if terminal_backend == "auto":
            terminal_backend = "mixture" if has else "rbf"
        if terminal_backend == "mixture" and not has:
            raise ValueError(f"terminal_backend='mixture' needs equation."
                             f"{bernstein}() -> (a, b) with {form}")
        if terminal_backend not in ("mixture", "rbf"):
            raise ValueError(f"unknown terminal_backend {terminal_backend!r}")
        self.terminal_backend = terminal_backend

    def GPsolver(self, x_t_domain, x_t_boundary, GN_steps: Optional[int] = None,
                 gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Fit the terminal representation; returns the posterior mean on
        the interior set.  ``GN_steps`` is accepted and ignored (nothing is
        trained by Newton).  ``gen`` draws the rbf centers (default: a
        generator on the GP's device seeded with CENTRE_SEED)."""
        x_dom = torch.as_tensor(x_t_domain, dtype=torch.float32, device=self.device)
        if self.terminal_backend == "mixture":
            self._fit_mixture(x_dom)
        else:
            if gen is None:
                gen = torch.Generator(device=self.device).manual_seed(CENTRE_SEED)
            x_bdy = torch.as_tensor(x_t_boundary, dtype=torch.float32,
                                    device=self.device)
            y_t = push_to_terminal(torch.cat([x_dom, x_bdy]), self.sig2,
                                   float(self.equation.T), gen)
            self._fit_rbf(x_dom, y_t)
        return self.predict(x_dom)


class GPHJBColeHopf(TerminalSemigroupGP):
    """Semigroup GP surrogate for HJB.  ``v_floor`` guards the log and the
    divisions against a non-positive v far from data."""

    def __init__(self, equation, config=None, precision=None, device=None,
                 v_floor: float = 1e-4, width: Optional[float] = None,
                 fit_nugget: float = 1e-4, terminal_backend: str = "auto", mesh=None):
        super().__init__(equation, config, precision=precision, device=device,
                         mesh=mesh)
        sig = float(equation.sigma())
        self.k = 2.0 / sig**2
        self.sig2 = sig**2
        self.v_floor = float(v_floor)
        self.fit_nugget = float(fit_nugget)
        self._set_backend(terminal_backend, "terminal_bernstein_v",
                          "g = ln((1+b|x|^2)/a)")
        # The width scales like sqrt(d): typical distances between points of
        # the diffusion-reachable set grow as sqrt(d sigma^2 T).
        horizon = float(equation.T) - float(getattr(equation, "t0", 0.0))
        self.width = (float(width) if width is not None
                      else 0.5 * (max(equation.dim, 1) * sig**2 * horizon) ** 0.5)

    def _fit_rbf(self, x_dom, y_t):
        """Fit v_T = exp(-k g) on the terminal centers y_t (m, d+1)."""
        v_T = torch.exp(-self.k * self.equation.g(y_t)[:, 0]).to(torch.float32)
        alpha, mbar, fit_rms = terminal_fit(sq_dists(y_t[:, :-1]), v_T,
                                            self.width, self.fit_nugget)
        self.state = GPState(
            x_dom=x_dom, x_bdy=y_t, right_vector=alpha, sol=v_T,
            gamma=torch.cat([torch.tensor([self.width, self.k], device=self.device),
                             mbar[None]]),
            loss_history=fit_rms[None],
        )

    def _fit_mixture(self, x_dom):
        """The exact Bernstein terminal mixture, discretized by the
        composite log-panel rule; weights go in ``right_vector`` and
        Gaussian rates in ``sol``."""
        from scasml_gp_torch.gp.semigroup import bernstein_panel_nodes

        a, b = map(float, self.equation.terminal_bernstein_v())
        k = self.k
        t, w = bernstein_panel_nodes(k)
        f32 = lambda v: torch.tensor(np.asarray(v, np.float32), device=self.device)  # noqa: E731
        self.state = GPState(
            x_dom=x_dom,
            x_bdy=torch.zeros((1, self.d + 1), dtype=torch.float32,
                              device=self.device),  # placeholder
            right_vector=f32((a**k) * w),
            sol=f32(b * t),
            gamma=f32([k, a, b]),
            loss_history=torch.zeros((1,), dtype=torch.float32, device=self.device),
        )

    # -- posterior --------------------------------------------------------
    def _v_posterior(self, params: GPState, x, want_grad, want_ops):
        T = float(self.equation.T)
        if self.terminal_backend == "mixture":
            from scasml_gp_torch.gp.semigroup import mixture_features

            return mixture_features(x, params.right_vector, params.sol, self.sig2,
                                    T, self.d, want_grad, want_ops)
        y = params.x_bdy[:, :-1]
        return chunked(
            lambda xc: _v_block(xc, y, params.right_vector, params.gamma[0],
                                params.gamma[2], self.sig2, T, self.d,
                                want_grad, want_ops),
            x, self.eval_chunk)

    def posterior_u(self, params: GPState, x_t, want_grad: bool = False,
                    want_ops: bool = False) -> PosteriorOut:
        x = torch.as_tensor(x_t, dtype=torch.float32, device=params.x_dom.device)
        # want_grad needs the ops pass too: the gradient's time column is
        # u_t = -v_t/(k v), and v_t comes from the ops pass.
        need = want_grad or want_ops
        v_raw, grad_sp, dt_v, div_v, lap_v = self._v_posterior(params, x, need, need)
        k = self.k
        v = torch.clamp_min(v_raw, self.v_floor)
        u = -torch.log(v) / k
        grad = None
        if want_grad:
            grad = torch.cat([-grad_sp / (k * v[:, None]),
                              (-dt_v / (k * v))[:, None]], dim=1)  # time last
        dt_u = div_u = lap_u = None
        if want_ops:
            dt_u = -dt_v / (k * v)
            div_u = -div_v / (k * v)
            lap_u = -lap_v / (k * v) + torch.sum(grad_sp * grad_sp, dim=1) / (k * v * v)
        return PosteriorOut(u=u, grad=grad, dt_u=dt_u, div_u=div_u, lap_u=lap_u)

    def residual_u(self, params: GPState, x_t) -> torch.Tensor:
        """Identically zero: the surrogate solves the v-PDE exactly and the
        Cole-Hopf |grad u|^2 terms cancel at k = 2/sigma^2."""
        return torch.zeros((x_t.shape[0], 1), dtype=torch.float32,
                           device=params.x_dom.device)
