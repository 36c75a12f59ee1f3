"""Reference-parity kernel mode: the biased frozen-subset Hutchinson
Laplacian and the fp16 quantization points of the reference, in closed form.

Port of ``scasml_gp_tpu/gp/parity.py``.  The reference estimates every
spatial Laplacian over a frozen subset S of 5 coordinates drawn once from
``PRNGKey(0)``,

    Lap f(x) ~= d * mean_{i in S} d^2 f / dx_i^2,

and its Laplacian blocks evaluate at the cyclically rolled point
``roll(y_t, -1)`` (it splits index 0 off as time, while time is the last
column).  Both quirks are deterministic biases.  Every biased block is still
a polynomial in a few pair statistics times the isotropic kernel; the JAX
module's docstring lists them, and these functions compute the same ones:

    kappa = exp(-gamma/2 |delta|^2), eps = delta[d], t = sum_{j<d} delta_j,
    Q = (d/m) sum_{i in S} delta_i^2,  P = (d/m) sum_{i in S} delta_i,

for delta = A - U in the block's frame (LAPS rolls its own side).  The fp16
toggle casts every block through float16, and the factorization is the
reference's fp64 SVD pseudo-Cholesky with the nugget added to |eigenvalue|.

The posterior here is XLA code in the JAX package, not a Pallas kernel, so it
runs as PyTorch operations and ``torch.matmul`` on either device.  The
subsets come from the table in ``gp/_subset_table.py``: torch cannot replay
``jax.random.choice``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from scasml_gp_torch.gp._subset_table import SUBSETS
from scasml_gp_torch.gp.posterior import PosteriorOut, _chunked, _split_r

ID, DT, DIV, LAPS = "id", "dt", "div", "laps"


def subset_indices(d: int, size: int = 5) -> Tuple[int, ...]:
    """The reference's frozen Hutchinson subset,
    ``random.choice(PRNGKey(0), d, shape=(size,), replace=False)``, from the
    table generated with JAX (``gp/_subset_table.py``)."""
    try:
        return SUBSETS[(int(d), int(size))]
    except KeyError:
        raise ValueError(
            f"no frozen subset for (d={d}, size={size}): the port's table "
            "scasml_gp_torch/gp/_subset_table.py holds size 5 for d = 5..255"
        ) from None


def _roll(x: torch.Tensor) -> torch.Tensor:
    """The reference's accidental permutation: [x_1..x_d, x_0]."""
    return torch.roll(x, -1, dims=-1)


class ParityStats(NamedTuple):
    kappa: torch.Tensor  # (n, m)
    eps: torch.Tensor    # (n, m) time-slot difference
    t: torch.Tensor      # (n, m) spatial-sum difference
    Q: torch.Tensor      # (n, m) scaled subset squared distance
    P: torch.Tensor      # (n, m) scaled subset sum difference


def parity_pair_stats(A, U, gamma, subset: Tuple[int, ...], d: int) -> ParityStats:
    """Pair statistics between rows of A and U (both (n, d+1), already in
    the block's evaluation frame)."""
    A = A.to(torch.float32)
    U = U.to(torch.float32)
    gamma = torch.as_tensor(gamma, dtype=torch.float32, device=A.device)
    scale = d / float(len(subset))
    idx = torch.as_tensor(subset, dtype=torch.long, device=A.device)
    r2 = (torch.sum(A * A, dim=1)[:, None] + torch.sum(U * U, dim=1)[None, :]
          - 2.0 * (A @ U.T))
    kappa = torch.exp(-0.5 * gamma * torch.clamp_min(r2, 0.0))
    eps = A[:, -1][:, None] - U[:, -1][None, :]
    t = torch.sum(A[:, :-1], dim=1)[:, None] - torch.sum(U[:, :-1], dim=1)[None, :]
    As, Us = A[:, idx], U[:, idx]
    q_sub = (torch.sum(As * As, dim=1)[:, None] + torch.sum(Us * Us, dim=1)[None, :]
             - 2.0 * (As @ Us.T))
    Q = scale * torch.clamp_min(q_sub, 0.0)
    P = scale * (torch.sum(As, dim=1)[:, None] - torch.sum(Us, dim=1)[None, :])
    return ParityStats(kappa=kappa, eps=eps, t=t, Q=Q, P=P)


def _frames(a: str, b: str, x, y):
    """The reference's roll quirk: a LAPS operator rolls its own side."""
    return (_roll(x) if a == LAPS else x), (_roll(y) if b == LAPS else y)


def parity_block(a: str, b: str, x, y, gamma, subset: Tuple[int, ...],
                 d: int) -> torch.Tensor:
    """The (n, m) biased block (D_x^a D_y^b kappa)(x_i, y_j) with reference
    semantics (subset Laplacian and roll)."""
    g = torch.as_tensor(gamma, dtype=torch.float32, device=x.device)
    m = float(len(subset))
    A, U = _frames(a, b, x, y)
    k, eps, t, Q, P = parity_pair_stats(A, U, g, subset, d)
    key = (a, b)
    if key == (ID, ID):
        return k
    if key == (ID, DT):
        return g * eps * k
    if key == (DT, ID):
        return -g * eps * k
    if key == (ID, DIV):
        return g * t * k
    if key == (DIV, ID):
        return -g * t * k
    if key in ((ID, LAPS), (LAPS, ID)):
        return g * (g * Q - d) * k
    if key == (DT, DT):
        return g * (1.0 - g * eps * eps) * k
    if key in ((DT, DIV), (DIV, DT)):
        return -g * g * eps * t * k
    if key == (DIV, DIV):
        return g * (d - g * t * t) * k
    if key == (DT, LAPS):
        return -g * g * eps * (g * Q - d) * k
    if key == (LAPS, DT):
        return g * g * eps * (g * Q - d) * k
    if key == (DIV, LAPS):
        return g * g * (2.0 * P + t * d - g * t * Q) * k
    if key == (LAPS, DIV):
        return g * g * (g * t * Q - 2.0 * P - t * d) * k
    if key == (LAPS, LAPS):
        return (g**4 * Q * Q - (2.0 * d + 4.0 * d / m) * g**3 * Q
                + (d * d + 2.0 * d * d / m) * g * g) * k
    raise ValueError(f"unknown operator pair {key}")


# phi order: [ID@dom, ID@bdy, LAPS@dom, DT@dom, DIV@dom].
_PHI_OPS = (ID, ID, LAPS, DT, DIV)
_PHI_SETS = ("dom", "bdy", "dom", "dom", "dom")


def _maybe_fp16(block: torch.Tensor, fp16: bool) -> torch.Tensor:
    """The reference casts every block to float16 before assembly."""
    return block.to(torch.float16).to(torch.float32) if fp16 else block


def parity_gram_matrix(x_dom, x_bdy, gamma, subset: Tuple[int, ...], dim: int,
                       fp16: bool = False) -> torch.Tensor:
    """The biased phi-phi Gram with reference semantics; symmetric, since
    each transposed pair of blocks evaluates the same even polynomial."""
    pts = {"dom": x_dom, "bdy": x_bdy}
    rows = [
        torch.cat([_maybe_fp16(parity_block(a, b, pts[sa], pts[sb], gamma, subset, dim),
                               fp16)
                   for b, sb in zip(_PHI_OPS, _PHI_SETS)], dim=1)
        for a, sa in zip(_PHI_OPS, _PHI_SETS)
    ]
    return torch.cat(rows, dim=0)


def parity_factorization(K: torch.Tensor, nugget: float, fp16: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's fp64 SVD pseudo-Cholesky: K = U S V^T, L = U sqrt(S +
    nugget), K_pert = L L^T.  Returns (K_pert, C = K_pert^{-1}) in float32
    on K's device.  The SVD of the symmetric K is its eigendecomposition
    with |eigenvalues| as singular values, so this is one float64
    ``torch.linalg.eigh`` on the device (the JAX package runs it on the host
    only because of the TPU's compile time); negative modes are reflected,
    not shifted."""
    K64 = K.to(torch.float64)
    K64 = 0.5 * (K64 + K64.T)
    lam, V = torch.linalg.eigh(K64)
    S = torch.abs(lam) + nugget
    if fp16:
        L = (V * torch.sqrt(S)[None, :]).to(torch.float16).to(torch.float64)
        K_pert = L @ L.T
        C = torch.linalg.inv(K_pert)
    else:
        K_pert = (V * S[None, :]) @ V.T
        C = (V / S[None, :]) @ V.T
    return K_pert.to(torch.float32), C.to(torch.float32)


def _parity_posterior_block(x, x_dom, x_bdy, r, gamma, subset, dim: int,
                            want_grad: bool, want_ops: bool,
                            fp16: bool) -> PosteriorOut:
    """Posterior mean, gradient and PDE-operator features with the
    reference's biased cross-kernels."""
    g = torch.as_tensor(gamma, dtype=torch.float32, device=x.device)
    d = dim
    m = float(len(subset))
    r1, r2, r3, r4, r5 = _split_r(r.to(torch.float32), x_dom.shape[0], x_bdy.shape[0])
    x = x.to(torch.float32)

    def feat(a: str):
        cols = [parity_block(a, ID, x, x_dom, g, subset, d),
                parity_block(a, ID, x, x_bdy, g, subset, d),
                parity_block(a, LAPS, x, x_dom, g, subset, d),
                parity_block(a, DT, x, x_dom, g, subset, d),
                parity_block(a, DIV, x, x_dom, g, subset, d)]
        return [_maybe_fp16(c, fp16) for c in cols]

    def contract(cols):
        c1, c2, c3, c4, c5 = cols
        return c1 @ r1 + c2 @ r2 + c3 @ r3 + c4 @ r4 + c5 @ r5

    u = contract(feat(ID))

    grad = None
    if want_grad:
        st_d = parity_pair_stats(x, x_dom, g, subset, d)
        st_b = parity_pair_stats(x, x_bdy, g, subset, d)
        st_l = parity_pair_stats(x, _roll(x_dom), g, subset, d)
        kd, kb, kl = st_d.kappa, st_b.kappa, st_l.kappa
        fam_id_d = kd * r1[None, :]
        fam_id_b = kb * r2[None, :]
        fam_dt = g * st_d.eps * kd * r4[None, :]
        fam_div = g * st_d.t * kd * r5[None, :]
        fam_lap = g * (g * st_l.Q - d) * kl * r3[None, :]
        idx = torch.as_tensor(subset, dtype=torch.long, device=x.device)
        scale = d / m

        def radial(W, Y):  # -gamma * sum_j W_ij (x_i - Y_j)
            return -g * (x * torch.sum(W, dim=1)[:, None] - W @ Y)

        grad = (radial(fam_id_d, x_dom) + radial(fam_id_b, x_bdy)
                + radial(fam_dt, x_dom) + radial(fam_div, x_dom)
                + radial(fam_lap, _roll(x_dom)))
        # DT family: + gamma kappa on the time slot; DIV: on every spatial
        # slot; LAPS: + gamma^2 (2d/m) delta_k kappa on the subset's slots
        grad[:, -1] += torch.sum(g * kd * r4[None, :], dim=1)
        grad[:, :-1] += torch.sum(g * kd * r5[None, :], dim=1)[:, None]
        W_l = g * g * (2.0 * scale) * kl * r3[None, :]
        y_sub = _roll(x_dom)[:, idx]
        extra_sub = x[:, idx] * torch.sum(W_l, dim=1)[:, None] - W_l @ y_sub
        grad[:, idx] += extra_sub

    dt_u = div_u = lap_u = None
    if want_ops:
        dt_u = contract(feat(DT))
        div_u = contract(feat(DIV))
        lap_u = contract(feat(LAPS))
    return PosteriorOut(u=u, grad=grad, dt_u=dt_u, div_u=div_u, lap_u=lap_u)


def make_parity_posterior(subset: Tuple[int, ...], fp16: bool = False):
    """A posterior with ``posterior_eval``'s signature, so GP.predict,
    compute_gradient, compute_PDE_loss and the ScaSML rollout all evaluate
    the reference-biased cross-kernels in parity mode."""

    def posterior(x, x_dom, x_bdy, r, gamma, dim, want_grad=False,
                  want_ops=False, chunk: Optional[int] = None,
                  operand_dtype=None, shard_dom=None, fused=None):
        # operand_dtype, shard_dom and fused are taken for the signature:
        # parity mode reproduces the reference's fp16 quantization points
        # (never bf16 operands) and the reference is single-device.
        del operand_dtype, shard_dom, fused
        gam = torch.as_tensor(gamma, dtype=torch.float32).reshape(-1)[0]
        return _chunked(lambda xc: _parity_posterior_block(
            xc, x_dom, x_bdy, r, gam, subset, dim, want_grad, want_ops, fp16),
            x, chunk)

    return posterior
