"""GP posterior variance of the PDE-collocation model.

Port of ``scasml_gp_tpu/gp/variance.py``:

    var(x) = kappa(x, x) - k_phi(x)^T (K + eta I)^{-1} k_phi(x),

with k_phi(x) the (4N+Nb,) cross vector of the identity operator at x
against the five training functionals [ID@dom, ID@bdy, LAP@dom, DT@dom,
DIV@dom], built from the same closed-form blocks as the Gram.  kappa(x, x)
= 1 for the ridge-augmented RBF family.  These are plain matrix products and
a factorization (``torch.matmul``, ``torch.linalg``), which the JAX package
left to XLA as well; no Pallas kernel is involved.
"""

from __future__ import annotations

from typing import Optional

import torch

from scasml_gp_torch.gp.gram import gram_matrix, regularized_factorization
from scasml_gp_torch.gp.kernels import ID, PHI_OPS, PHI_SETS, op_block, pair_stats


def cross_phi(x, x_dom, x_bdy, gamma, dim: int,
              operand_dtype=torch.float32) -> torch.Tensor:
    """(n, 4N+Nb) cross-kernel matrix [kappa_op(x, phi_j)] with ID on the x
    side, in the Gram / right_vector column order."""
    st = {"dom": pair_stats(x, x_dom, gamma, operand_dtype),
          "bdy": pair_stats(x, x_bdy, gamma, operand_dtype)}
    return torch.cat(
        [op_block(ID, b, st[sb], gamma, dim) for b, sb in zip(PHI_OPS, PHI_SETS)],
        dim=1,
    )


def factor_for_variance(x_dom, x_bdy, gamma, nugget, dim: int,
                        operand_dtype=torch.float32) -> torch.Tensor:
    """C = (K + nugget I)^{-1} rebuilt from a trained state's points (the
    train-time factor is not kept in GPState)."""
    K = gram_matrix(x_dom, x_bdy, gamma, dim, operand_dtype)
    _, C = regularized_factorization(K, float(nugget))
    return C


def posterior_variance(x, x_dom, x_bdy, C, gamma, dim: int,
                       chunk: Optional[int] = None,
                       operand_dtype=torch.float32) -> torch.Tensor:
    """Pointwise posterior variance (n,), clipped at >= 0; ``chunk`` bounds
    the (chunk, phi) cross tile."""
    def block(xc):
        kx = cross_phi(xc, x_dom, x_bdy, gamma, dim, operand_dtype)
        return torch.clamp_min(1.0 - torch.sum((kx @ C) * kx, dim=1), 0.0)

    n = x.shape[0]
    if chunk is None or n <= chunk:
        return block(x)
    return torch.cat([block(x[i: i + chunk]) for i in range(0, n, chunk)])
