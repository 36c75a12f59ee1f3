"""Gram-matrix assembly and factorization for the GP PDE surrogate.

Port of ``scasml_gp_tpu/gp/gram.py``: the (4N + Nb)^2 Gram over
phi = [ID@dom, ID@bdy, LAP@dom, DT@dom, DIV@dom] from the closed-form blocks
of :mod:`scasml_gp_torch.gp.kernels`, the Jacobi-equilibrated float32
Cholesky with a jitter ladder and an explicit inverse, and the
differentiable log-determinant and quadratic form of the marginal-likelihood
fit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from scasml_gp_torch.gp.kernels import PHI_OPS, PHI_SETS, PairStats, op_block, pair_stats

_JITTERS = (1e-3, 1e-1, 10.0)  # retried in order after a failed factorization


def gram_matrix(x_dom, x_bdy, gamma, dim: int,
                operand_dtype=torch.float32) -> torch.Tensor:
    """Full phi-phi Gram, shape (4N+Nb, 4N+Nb), float32.  A batch (R, 3)
    of gammas gives (R, 4N+Nb, 4N+Nb): the pair statistics but kappa are
    formed once, and each K[r] is bitwise the Gram of gamma[r] (the same
    elementwise work in the same order)."""
    pts = {"dom": x_dom, "bdy": x_bdy}
    stats = {
        (a, b): pair_stats(pts[a], pts[b], gamma, operand_dtype)
        for a in pts for b in pts
    }
    rows = [
        torch.cat([
            op_block(a, b, stats[(sa, sb)], gamma, dim)
            for b, sb in zip(PHI_OPS, PHI_SETS)
        ], dim=-1)
        for a, sa in zip(PHI_OPS, PHI_SETS)
    ]
    return torch.cat(rows, dim=-2)


def gram_rows(x_dom, x_bdy, gamma, dim: int, lo: int, hi: int,
              operand_dtype=torch.float32) -> torch.Tensor:
    """Rows [lo, hi) of ``gram_matrix``, shape (hi - lo, 4N+Nb): each phi
    family's rows that fall in the range, against every column.  The pair
    statistics are formed for whole point sets and cut to the rows (one
    product and a few elementwise passes, beside the blocks' many), so the
    rows are bitwise those of ``gram_matrix``: a row block of another shape
    could take another summation order in the product, which the wide
    kernels' ill-conditioned factorization would amplify."""
    pts = {"dom": x_dom, "bdy": x_bdy}
    stats, blocks, start = {}, [], 0
    for a, sa in zip(PHI_OPS, PHI_SETS):
        size = pts[sa].shape[0]
        a_lo, a_hi = max(lo, start) - start, min(hi, start + size) - start
        if a_lo < a_hi:
            for sb in pts:
                if (sa, sb) not in stats:
                    stats[sa, sb] = pair_stats(pts[sa], pts[sb], gamma, operand_dtype)
            rows = {sb: PairStats(*(v[a_lo:a_hi] for v in stats[sa, sb])) for sb in pts}
            blocks.append(torch.cat([op_block(a, b, rows[sb], gamma, dim)
                                     for b, sb in zip(PHI_OPS, PHI_SETS)], dim=1))
        start += size
    return torch.cat(blocks, dim=0)


def sharded_gram_matrix(x_dom, x_bdy, gamma, dim: int, mesh,
                        operand_dtype=torch.float32) -> torch.Tensor:
    """``gram_matrix`` assembled over the mesh's 'model' axis: each rank
    computes its block of rows and the ranks gather the blocks, so every
    rank holds the whole Gram, bitwise ``gram_matrix``'s."""
    from scasml_gp_torch.parallel.mesh import all_gather_rows, split_range

    phi = 4 * x_dom.shape[0] + x_bdy.shape[0]
    lo, hi = split_range(phi, mesh.model, mesh.model_index)
    counts = [b - a for a, b in (split_range(phi, mesh.model, i) for i in range(mesh.model))]
    return all_gather_rows(gram_rows(x_dom, x_bdy, gamma, dim, lo, hi, operand_dtype),
                           mesh.model_group, counts)


def regularized_factorization(K: torch.Tensor, nugget
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
    factorization.

    K may be a batch (R, phi, phi) with ``nugget`` (R,): each restart is
    factored, and retried up the jitter ladder, on its own."""
    K = 0.5 * (K + K.mT)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    nugget = torch.as_tensor(nugget, dtype=K.dtype, device=K.device)
    K_pert = K + nugget[..., None, None] * eye
    diag = torch.clamp_min(torch.diagonal(K, dim1=-2, dim2=-1), 1e-12)
    scale = torch.rsqrt(diag + nugget[..., None])
    M = scale[..., :, None] * K_pert * scale[..., None, :]
    L = _cholesky_with_retry(M, eye)
    Minv = per_matrix(torch.cholesky_inverse, L)
    C = scale[..., :, None] * Minv * scale[..., None, :]
    return K_pert, C


def logdet_quad(K: torch.Tensor, nugget, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log det(K + nugget I), b^T (K + nugget I)^{-1} b) in float32,
    differentiable in K, ``nugget`` and b (the marginal-likelihood fit,
    gp/marginal.py).  K may be a batch (R, phi, phi) with ``nugget`` (R,)
    and b (R, phi): one logdet and one quad per restart.

    The same Jacobi equilibration as :func:`regularized_factorization`: with
    M = D^{-1/2} (K + nugget I) D^{-1/2},
        logdet = sum log d_i + 2 sum log diag chol(M),
        quad   = || chol(M)^{-1} D^{-1/2} b ||^2.
    A probe factorization of M without gradients decides, per restart,
    whether a jitter of 1e-3 is added, so the Cholesky that is
    differentiated only ever sees a finite operand; a restart whose
    factorization fails even so gets a NaN factor, which reaches no other
    restart's value or gradient.  No host sync: the decisions stay on the
    device."""
    K = 0.5 * (K + K.mT)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    nugget = torch.as_tensor(nugget, dtype=K.dtype, device=K.device)
    diag = torch.clamp_min(torch.diagonal(K, dim1=-2, dim2=-1), 1e-12) + nugget[..., None]
    scale = torch.rsqrt(diag)
    M = scale[..., :, None] * (K + nugget[..., None, None] * eye) * scale[..., None, :]
    probe, info = per_matrix(torch.linalg.cholesky_ex, M.detach())
    ok = (info == 0) & torch.isfinite(probe).all(dim=-1).all(dim=-1)
    jitter = torch.where(ok, 0.0, 1e-3)[..., None, None]
    L, info = per_matrix(torch.linalg.cholesky_ex, M + jitter * eye)
    # a factorization that fails even so is NaN, as the JAX package's is
    L = torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))
    logdet = torch.sum(torch.log(diag), dim=-1) + 2.0 * torch.sum(
        torch.log(torch.clamp_min(torch.diagonal(L, dim1=-2, dim2=-1), 1e-30)), dim=-1)
    w = torch.linalg.solve_triangular(L, (scale * b)[..., :, None], upper=False)
    return logdet, torch.sum(w * w, dim=(-2, -1))


def per_matrix(fn, *mats):
    """``fn(*mats)`` for matrices (n, n); for batches (R, n, n), one call
    of ``fn`` per matrix and the results stacked.  On the card PyTorch
    hands a batch of matrices of the fit's size to batched routines built
    for small ones (cuSOLVER's potrfBatched, MAGMA's batched LU, which warns
    so), slower there than one call per matrix (measure.py --parts fit);
    and one call per matrix keeps each restart of a batched train the
    single train's computation, bit for bit on the CPU."""
    if mats[0].dim() == 2:
        return fn(*mats)
    outs = [fn(*ms) for ms in zip(*mats)]
    if isinstance(outs[0], tuple):
        return tuple(_stack(parts) for parts in zip(*outs))
    return _stack(outs)


def _stack(parts):
    """torch.stack keeping the parts' layout: the solvers return
    column-major matrices, and a later product on a row-major copy would
    take another BLAS route, with other bits, than on the single result."""
    if parts[0].dim() >= 2 and not parts[0].is_contiguous() and parts[0].mT.is_contiguous():
        return torch.stack([p.mT for p in parts]).mT
    return torch.stack(parts)


def _cholesky_with_retry(M: torch.Tensor, eye: torch.Tensor) -> torch.Tensor:
    """chol(M + jitter*I) with jitter 0, then 1e-3, 1e-1, 10, stopping at
    the first success, for each matrix of a batch on its own: a matrix that
    factored keeps its factor bitwise, and only the failed ones are
    factored again.  ``cholesky_ex`` reports failure in ``info``, read on
    the host once per rung for the whole batch.  A matrix that fails every
    try gets a NaN factor, as the JAX package's NaN-returning Cholesky
    leaves it."""
    L, info = per_matrix(torch.linalg.cholesky_ex, M)
    n = M.shape[-1]
    Ls, infos, Ms = L.view(-1, n, n), info.view(-1), M.reshape(-1, n, n)
    for jitter in _JITTERS:
        bad = torch.nonzero(infos)[:, 0]
        if bad.numel() == 0:
            return L
        Ls[bad], infos[bad] = per_matrix(torch.linalg.cholesky_ex, Ms[bad] + jitter * eye)
    bad = torch.nonzero(infos)[:, 0]
    Ls[bad] = float("nan")
    return L
