"""Gram-matrix assembly and factorization for the GP PDE surrogate.

Port of ``scasml_gp_tpu/gp/gram.py``: the (4N + Nb)^2 Gram over
phi = [ID@dom, ID@bdy, LAP@dom, DT@dom, DIV@dom] from the closed-form blocks
of :mod:`scasml_gp_torch.gp.kernels`, and the Jacobi-equilibrated float32
Cholesky with a jitter ladder and an explicit potri-style inverse.
"""

from __future__ import annotations

from typing import Tuple

import torch

from scasml_gp_torch.gp.kernels import PHI_OPS, PHI_SETS, op_block, pair_stats

_JITTERS = (1e-3, 1e-1, 10.0)  # retried in order after a failed factorization


def gram_matrix(x_dom, x_bdy, gamma, dim: int,
                operand_dtype=torch.float32) -> torch.Tensor:
    """Full phi-phi Gram, shape (4N+Nb, 4N+Nb), float32."""
    pts = {"dom": x_dom, "bdy": x_bdy}
    stats = {
        (a, b): pair_stats(pts[a], pts[b], gamma, operand_dtype)
        for a in pts for b in pts
    }
    rows = [
        torch.cat([
            op_block(a, b, stats[(sa, sb)], gamma, dim)
            for b, sb in zip(PHI_OPS, PHI_SETS)
        ], dim=1)
        for a, sa in zip(PHI_OPS, PHI_SETS)
    ]
    return torch.cat(rows, dim=0)


def regularized_factorization(K: torch.Tensor, nugget: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K_pert, C) with K_pert = sym(K) + nugget*I and C = K_pert^{-1}.

    The Gram's derivative blocks differ in scale by O(d^2), so the factored
    matrix is the Jacobi-equilibrated M = D^{-1/2} K_pert D^{-1/2}; then
    K_pert^{-1} = D^{-1/2} M^{-1} D^{-1/2}.  The explicit inverse is needed:
    the Newton step reads dense blocks of C for its analytic Hessian.

    M^{-1} comes from ``cholesky_inverse`` (two triangular solves against
    L), not from the JAX package's Linv^T Linv: at the wide kernels the tuner
    picks (d=20, N=1000, M's condition number ~1e7) the float32 product of
    two inexact triangular inverses left the GP at rel-L2 0.117 on an H100,
    against 0.019 with cholesky_inverse and 0.019 with a float64
    factorization."""
    K = 0.5 * (K + K.T)
    eye = torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    K_pert = K + nugget * eye
    diag = torch.clamp_min(torch.diagonal(K), 1e-12)
    scale = torch.rsqrt(diag + nugget)
    M = scale[:, None] * K_pert * scale[None, :]
    L = _cholesky_with_retry(M, eye)
    Minv = torch.cholesky_inverse(L)
    C = scale[:, None] * Minv * scale[None, :]
    return K_pert, C


def _cholesky_with_retry(M: torch.Tensor, eye: torch.Tensor) -> torch.Tensor:
    """chol(M + jitter*I) with jitter 0, then 1e-3, 1e-1, 10, stopping at
    the first success.  ``cholesky_ex`` reports failure in ``info`` (one
    host sync per try).  If every try fails the factor is NaN, as the JAX
    package's NaN-returning Cholesky leaves it."""
    L, info = torch.linalg.cholesky_ex(M)
    for jitter in _JITTERS:
        if int(info) == 0:
            return L
        L, info = torch.linalg.cholesky_ex(M + jitter * eye)
    if int(info) != 0:
        L = torch.full_like(L, float("nan"))
    return L
