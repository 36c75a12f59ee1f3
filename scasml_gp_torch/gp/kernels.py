"""Closed-form space-time RBF derivative kernel algebra.

Port of ``scasml_gp_tpu/gp/kernels.py``.  The kernel is the ridge-augmented
separable space/time RBF

    kappa(x, y) = exp(-(gs*q + gr*s^2 + gt*dt^2) / 2)

with, for delta = x - y: q = |delta_spatial|^2, s = sum_i delta_i (spatial),
dt = delta_time.  (gs, gt, gr) = (g, g, 0) is the isotropic kernel.  Every
operator block D_x^a D_y^b kappa for a, b in {ID, LAP, DT, DIV} is a
polynomial in (q, s, dt) times kappa; the derivation is in the JAX module's
docstring.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

# y-side feature operators defining phi, in column order
# [ID@dom, ID@bdy, LAP@dom, DT@dom, DIV@dom].
ID, LAP, DT, DIV = "id", "lap", "dt", "div"
PHI_OPS = (ID, ID, LAP, DT, DIV)
PHI_SETS = ("dom", "bdy", "dom", "dom", "dom")


def split_gamma(gamma) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normalize gamma to (gs, gt, gr) 0-d float32 tensors: accepts a scalar
    (isotropic), a length-2 [gs, gt] or a length-3 [gs, gt, gr]."""
    g = torch.as_tensor(gamma, dtype=torch.float32).reshape(-1)
    if g.shape[0] == 1:
        return g[0], g[0], torch.zeros((), dtype=torch.float32, device=g.device)
    if g.shape[0] == 2:
        return g[0], g[1], torch.zeros((), dtype=torch.float32, device=g.device)
    return g[0], g[1], g[2]


class PairStats(NamedTuple):
    """Pairwise statistics between rows of x (n, d+1) and y (m, d+1)."""

    kappa: torch.Tensor  # (n, m) base kernel values
    q: torch.Tensor      # (n, m) squared spatial distance
    s: torch.Tensor      # (n, m) sum of spatial differences
    dt: torch.Tensor     # (n, m) time difference x_t - y_t


def row_stats(x: torch.Tensor) -> torch.Tensor:
    """(n, 3) per row: |x|^2, the spatial sum and the time, the row side of
    the norm form of ``pair_stats``."""
    return torch.stack(
        [torch.sum(x * x, dim=1), torch.sum(x[:, :-1], dim=1), x[:, -1]], dim=1)


def pair_stats(x: torch.Tensor, y: torch.Tensor, gamma,
               operand_dtype=torch.float32, y_stats=None) -> PairStats:
    """Pair statistics from one x @ y^T product in float32.

    r^2 is formed as |x|^2 + |y|^2 - 2 x.y and clamped at 0, as in the JAX
    package; this is why the port must not run float32 products in TF32.
    ``operand_dtype=torch.bfloat16`` rounds the operands to bf16 first
    (products of bf16 values are exact in float32, so this equals bf16
    operands with float32 accumulation); ``operand_dtype=torch.float64``
    computes in float64 (a reference for the float32 paths).  ``y_stats``
    may carry ``row_stats(y)`` computed once for a fixed y."""
    gs, gt, gr = split_gamma(gamma)
    work = torch.float64 if operand_dtype == torch.float64 else torch.float32
    x = x.to(operand_dtype).to(work)
    y = y.to(operand_dtype).to(work)
    xs = row_stats(x)
    ys = row_stats(y) if y_stats is None else y_stats
    xy = x @ y.T
    r2 = xs[:, 0][:, None] + ys[:, 0][None, :] - 2.0 * xy
    r2 = torch.clamp_min(r2, 0.0)
    dt = xs[:, 2][:, None] - ys[:, 2][None, :]
    s = xs[:, 1][:, None] - ys[:, 1][None, :]
    q = torch.clamp_min(r2 - dt * dt, 0.0)
    kappa = torch.exp(-0.5 * (gs * q + gr * s * s + gt * dt * dt))
    return PairStats(kappa=kappa, q=q, s=s, dt=dt)


def _aux(gamma, d: int):
    """Shared scalar combinations (G, beta) of the gamma components."""
    gs, gt, gr = split_gamma(gamma)
    G = gs + d * gr
    beta = 2.0 * gs * gr + d * gr * gr
    return gs, gt, gr, G, beta


def _lapf(st: PairStats, gs, gr, beta, d):
    """One-sided spatial Laplacian factor: Lap_x kappa = LAPF * kappa."""
    return gs * gs * st.q + beta * st.s * st.s - d * (gs + gr)


def op_block(a: str, b: str, st: PairStats, gamma, d: int) -> torch.Tensor:
    """The (n, m) matrix of (D_x^a D_y^b kappa)(x_i, y_j)."""
    gs, gt, gr, G, beta = _aux(gamma, d)
    k, q, s, dt = st.kappa, st.q, st.s, st.dt
    lapf = _lapf(st, gs, gr, beta, d)

    key = (a, b)
    if key == (ID, ID):
        return k
    if key in ((ID, LAP), (LAP, ID)):
        return lapf * k
    if key == (ID, DT):
        return gt * dt * k
    if key == (DT, ID):
        return -gt * dt * k
    if key == (ID, DIV):
        return G * s * k
    if key == (DIV, ID):
        return -G * s * k
    if key == (DT, DT):
        return gt * (1.0 - gt * dt * dt) * k
    if key in ((DT, DIV), (DIV, DT)):
        return -G * gt * s * dt * k
    if key == (DIV, DIV):
        return G * (d - G * s * s) * k
    if key == (LAP, DT):
        return gt * dt * lapf * k
    if key == (DT, LAP):
        return -gt * dt * lapf * k
    if key == (DIV, LAP):
        return G * s * (2.0 * G - lapf) * k
    if key == (LAP, DIV):
        return -G * s * (2.0 * G - lapf) * k
    if key == (LAP, LAP):
        return (
            2.0 * d * (gs * gs + beta)
            - 4.0 * gs**3 * q
            - 4.0 * s * s * (gs * gs * gr + beta * G)
            + lapf * lapf
        ) * k
    raise ValueError(f"unknown operator pair {key}")


class GradCoeffs(NamedTuple):
    """Coefficients of grad_x (D_y^b kappa) in the basis
    {delta_spatial, s * 1_sp, ones_spatial, dt * e_t, e_t}."""

    a_sp: torch.Tensor
    b_s: torch.Tensor
    c: torch.Tensor
    a_t: torch.Tensor
    e: torch.Tensor


def grad_coeffs(b: str, st: PairStats, gamma, d: int) -> GradCoeffs:
    """Coefficients of the x-gradient of the y-side family ``b``."""
    gs, gt, gr, G, beta = _aux(gamma, d)
    k, s, dt = st.kappa, st.s, st.dt
    lapf = _lapf(st, gs, gr, beta, d)
    zero = torch.zeros_like(k)
    if b == ID:
        return GradCoeffs(a_sp=-gs * k, b_s=-gr * k, c=zero, a_t=-gt * k,
                          e=zero)
    if b == LAP:
        return GradCoeffs(
            a_sp=(2.0 * gs * gs - gs * lapf) * k,
            b_s=(2.0 * beta - gr * lapf) * k,
            c=zero,
            a_t=-gt * lapf * k,
            e=zero,
        )
    if b == DT:
        return GradCoeffs(
            a_sp=-gs * gt * dt * k,
            b_s=-gr * gt * dt * k,
            c=zero,
            a_t=-gt * gt * dt * k,
            e=gt * k,
        )
    if b == DIV:
        return GradCoeffs(
            a_sp=-G * gs * s * k,
            b_s=-G * gr * s * k,
            c=G * k,
            a_t=-G * gt * s * k,
            e=zero,
        )
    raise ValueError(f"unknown family {b}")


def kernel_gamma(eq_sigma: float, dim: int) -> float:
    """Isotropic gamma = 1/sigma_k^2 with sigma_k = eq.sigma() * sqrt(d)."""
    return 1.0 / (eq_sigma * eq_sigma * dim)


def kernel_gammas(eq_sigma: float, dim: int, time_scale: float = 1.0,
                  ridge_scale: float = 0.0):
    """(gs, gt, gr) for the ridge-augmented separable kernel; the defaults
    give the isotropic kernel."""
    gs = kernel_gamma(eq_sigma, dim)
    gt = gs / (time_scale * time_scale)
    gr = ridge_scale * gs / dim
    return (gs, gt, gr)
