"""Reaction-semigroup surrogate for the Allen-Cahn equation.

Port of ``scasml_gp_tpu/gp/semigroup.py``.  Allen-Cahn here is
u_t + Lap u + u - u^3 = 0, u(x, T) = 1/(2 + 0.4|x|^2), sigma = sqrt(2),
T = 0.3.  The surrogate solves the linearized flow
u_t + (sigma^2/2) Lap u + lam u = 0 (lam = f'(0) = 1) exactly:
u(x, t) = e^{lam tau} (P_tau g)(x), with P the heat semigroup, which acts on
Gaussians in closed form.  Two terminal representations:

- ``mixture``: g = 1/(a + b|x|^2) is completely monotone in |x|^2, so it is
  an exact mixture of origin-centered Gaussians (Bernstein), discretized by
  the composite log-panel rule of :func:`bernstein_panel_nodes`;
- ``rbf``: the scattered constant-mean RBF interpolant of the Cole-Hopf
  surrogate (gp/cole_hopf.py), with its width selected over ``_BETA_GRID``
  by held-out terminal-fit error.

Its Allen-Cahn residual is exactly -u^3, the dropped cubic term, which
ScaSML's leaf injection then carries.  Evaluation is plain PyTorch (one
(n, nq) block for the mixture); no Pallas kernel is involved.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from scasml_gp_torch.gp.cole_hopf import (
    TerminalSemigroupGP,
    _v_block,
    chunked,
    sq_dists,
    terminal_fit,
)
from scasml_gp_torch.gp.posterior import PosteriorOut
from scasml_gp_torch.gp.solver import AllenCahnForm
from scasml_gp_torch.gp.state import GPState

# held-out width-selection grid for the rbf backend, in units of
# sqrt(d sigma^2 T)
_BETA_GRID = (0.5, 0.6, 0.7, 0.8, 1.0)


def bernstein_panel_nodes(k: float, t_min: float = 1e-5, t_max: float = 60.0,
                          per_panel: int = 8, ratio: float = 2.0):
    """Composite log-panel Gauss-Legendre nodes and weights (numpy float64)
    for (1 + bq)^{-k} = (1/Gamma(k)) int_0^inf t^{k-1} e^{-t} e^{-tbq} dt.
    Panels are log-spaced from ``t_min`` to ``t_max``, so every
    concentration scale t ~ 1/(d sig2 tau) >= t_min is resolved; w absorbs
    t^{k-1} e^{-t} / Gamma(k).  The same numpy arithmetic as the JAX
    package, so the nodes are the same bits."""
    gx, gw = np.polynomial.legendre.leggauss(per_panel)
    edges = [0.0, t_min]
    while edges[-1] < t_max:
        edges.append(min(edges[-1] * ratio, t_max))
    ts, ws = [], []
    for lo, hi in zip(edges[:-1], edges[1:]):
        mid, half = 0.5 * (hi + lo), 0.5 * (hi - lo)
        t = mid + half * gx
        ts.append(t)
        ws.append(half * gw * np.power(t, k - 1.0) * np.exp(-t))
    return np.concatenate(ts), np.concatenate(ws) / math.gamma(k)


def mixture_features(x, weights, rates, sig2, T, dim, want_grad: bool,
                     want_ops: bool):
    """Heat evolution of F(y) = sum_k w_k e^{-c_k |y|^2}:

        V(x, t) = sum_k w_k den_k^{-d/2} exp(-c_k r^2 / den_k),
        den_k = 1 + 2 c_k sig2 tau,  tau = T - t,  r^2 = |x|^2.

    Returns (V, grad_sp, dt_V, div_V, lap_V), dt_V = -(sig2/2) lap_V."""
    xs = x[:, :dim]
    tau = torch.clamp_min(T - x[:, dim], 0.0)
    r2 = torch.sum(xs * xs, dim=1)
    den = 1.0 + 2.0 * rates[None, :] * sig2 * tau[:, None]     # (n, nq)
    ceff = rates[None, :] / den
    # den^{-d/2} as exp(-(d/2) log den): a float32 pow is not stable at large d
    A = weights[None, :] * torch.exp(-0.5 * dim * torch.log(den) - ceff * r2[:, None])
    V = torch.sum(A, dim=1)
    grad_sp = dt_V = div_V = lap_V = None
    if want_grad or want_ops:
        B = torch.sum(A * ceff, dim=1)
        grad_sp = -2.0 * B[:, None] * xs
    if want_ops:
        C2 = torch.sum(A * ceff * ceff, dim=1)
        lap_V = -2.0 * dim * B + 4.0 * C2 * r2
        dt_V = -(sig2 / 2.0) * lap_V                           # exact
        div_V = -2.0 * B * torch.sum(xs, dim=1)
    return V, grad_sp, dt_V, div_V, lap_V


def _width_split(m: int, seed: int, device) -> torch.Tensor:
    """Permutation of the m centers for the held-out width selection."""
    return torch.randperm(m, generator=torch.Generator(device=device).manual_seed(seed),
                          device=device)


class GPAllenCahnSemigroup(TerminalSemigroupGP):
    """Reaction-semigroup surrogate for Allen-Cahn.  ``terminal_backend=
    'auto'`` uses the exact mixture when the equation exposes
    ``terminal_bernstein()`` and the scattered RBF fit otherwise."""

    form_cls = AllenCahnForm

    def __init__(self, equation, config=None, precision=None, device=None,
                 width: Optional[float] = None, fit_nugget: float = 1e-4,
                 reaction: Optional[float] = None,
                 terminal_backend: str = "auto"):
        super().__init__(equation, config, precision=precision, device=device)
        sig = float(equation.sigma())
        self.sig2 = sig**2
        self.fit_nugget = float(fit_nugget)
        self.lam = 1.0 if reaction is None else float(reaction)  # f'(0)
        self._set_backend(terminal_backend, "terminal_bernstein",
                          "g = 1/(a + b |x|^2)")
        # None selects the rbf width from _BETA_GRID at train time
        self._width_arg = width
        horizon = float(equation.T) - float(getattr(equation, "t0", 0.0))
        self._width_unit = (max(equation.dim, 1) * sig**2 * horizon) ** 0.5

    def _fit_mixture(self, x_dom):
        """1/(a + b q) = (1/a) int e^{-t} e^{-(b/a) t q} dt on the log-panel
        rule: weights in ``right_vector``, rates in ``sol``,
        gamma = [lam, a, b]."""
        a, b = map(float, self.equation.terminal_bernstein())
        t, w = bernstein_panel_nodes(1.0)
        f32 = lambda v: torch.tensor(np.asarray(v, np.float32), device=self.device)  # noqa: E731
        self.state = GPState(
            x_dom=x_dom,
            x_bdy=torch.zeros((1, self.d + 1), dtype=torch.float32,
                              device=self.device),  # placeholder
            right_vector=f32(w / a),
            sol=f32((b / a) * t),
            gamma=f32([self.lam, a, b]),
            loss_history=torch.zeros((1,), dtype=torch.float32, device=self.device),
        )

    def _fit_rbf(self, x_dom, y_t):
        """Fit g on the terminal centers y_t (m, d+1); gamma = [width, mbar,
        lam]."""
        g_T = self.equation.g(y_t)[:, 0].to(torch.float32)
        d2 = sq_dists(y_t[:, :-1])
        width = (float(self._width_arg) if self._width_arg is not None
                 else self._select_width(d2, g_T, torch.mean(g_T)))
        alpha, mbar, fit_rms = terminal_fit(d2, g_T, width, self.fit_nugget)
        self.state = GPState(
            x_dom=x_dom, x_bdy=y_t, right_vector=alpha, sol=g_T,
            gamma=torch.cat([torch.tensor([width], device=self.device), mbar[None],
                             torch.tensor([self.lam], device=self.device)]),
            loss_history=fit_rms[None],
        )

    def _select_width(self, d2, g_T, mbar, frac: float = 0.2,
                      seed: int = 0) -> float:
        """The width from the beta grid with the least held-out
        terminal-fit RMS: fit on (1 - frac) of the centers, score the rest
        (one host sync per grid point)."""
        m = g_T.shape[0]
        nv = max(1, int(m * frac))
        perm = _width_split(m, seed, d2.device)
        vi, ti = perm[:nv], perm[nv:]
        Ktt_d2 = d2[ti][:, ti]
        Kvt_d2 = d2[vi][:, ti]
        g_t, g_v = g_T[ti] - mbar, g_T[vi] - mbar
        eye = torch.eye(ti.shape[0], dtype=torch.float32, device=d2.device)
        best_w, best_s = None, None
        for beta in _BETA_GRID:
            width = beta * self._width_unit
            Ktt = torch.exp(-Ktt_d2 / (2.0 * width**2))
            al = torch.linalg.solve(Ktt + self.fit_nugget * eye, g_t)
            pred = torch.exp(-Kvt_d2 / (2.0 * width**2)) @ al
            s = float(torch.sqrt(torch.mean((pred - g_v) ** 2)))
            if best_s is None or s < best_s:
                best_w, best_s = width, s
        return best_w

    # -- posterior --------------------------------------------------------
    def _features(self, params: GPState, x, need):
        T = float(self.equation.T)
        if self.terminal_backend == "mixture":
            return mixture_features(x, params.right_vector, params.sol, self.sig2,
                                    T, self.d, need, need)
        y = params.x_bdy[:, :-1]
        return chunked(
            lambda xc: _v_block(xc, y, params.right_vector, params.gamma[0],
                                params.gamma[1], self.sig2, T, self.d, need, need),
            x, self.eval_chunk)

    def posterior_u(self, params: GPState, x_t, want_grad: bool = False,
                    want_ops: bool = False) -> PosteriorOut:
        x = torch.as_tensor(x_t, dtype=torch.float32, device=params.x_dom.device)
        # want_grad needs the ops pass too: the gradient's time column is
        # u_t = -lam u - (sigma^2/2) Lap u, and Lap comes from the ops pass.
        need = want_grad or want_ops
        V, grad_sp_V, dt_V, div_V, lap_V = self._features(params, x, need)
        lam = self.lam
        tau = torch.clamp_min(float(self.equation.T) - x[:, -1], 0.0)
        amp = torch.exp(lam * tau)
        u = amp * V
        grad = dt_u = div_u = lap_u = None
        if need:
            # u_t = -lam e^{lam tau} V + e^{lam tau} V_t
            dt_u_val = -lam * u + amp * dt_V
        if want_grad:
            grad = torch.cat([amp[:, None] * grad_sp_V, dt_u_val[:, None]], dim=1)
        if want_ops:
            dt_u = dt_u_val
            div_u = amp * div_V
            lap_u = amp * lap_V
        return PosteriorOut(u=u, grad=grad, dt_u=dt_u, div_u=div_u, lap_u=lap_u)

    # residual_u is inherited from GP: posterior_u(want_ops=True) and
    # AllenCahnForm.residual, which is exactly -u^3 here.
