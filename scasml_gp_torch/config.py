"""Typed configuration for the PyTorch port.

Same fields and defaults as the JAX package's ``scasml_gp_tpu/config.py``
(``PrecisionPolicy``, ``GPConfig``), with dtype properties returning torch
dtypes.  Options the port does not run yet are kept as fields so a config
written for the JAX package loads unchanged; the modules that would read them
raise ``NotImplementedError`` for any non-default value.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Operand dtype of the pair-statistics products (``gram``) and storage
    dtype of the Brownian sample paths in the Picard rollouts (``rollout``).
    Factorizations, accumulators and reductions are always float32."""

    gram: str = "float32"     # 'float32' | 'bfloat16'
    rollout: str = "float32"  # 'float32' | 'bfloat16' | 'float16'

    def __post_init__(self):
        allowed = {"gram": ("float32", "bfloat16"),
                   "rollout": ("float32", "bfloat16", "float16")}
        for field, ok in allowed.items():
            val = getattr(self, field)
            if val not in ok:
                raise ValueError(
                    f"PrecisionPolicy.{field} must be one of {ok}, got {val!r}"
                )

    @property
    def gram_dtype(self) -> torch.dtype:
        return DTYPES[self.gram]

    @property
    def rollout_dtype(self) -> torch.dtype:
        return DTYPES[self.rollout]


@dataclasses.dataclass(frozen=True)
class GPConfig:
    """Gaussian-process surrogate knobs (reference ``models/GP.py``)."""

    nugget: float = 1e-2
    time_scale: float = 1.0         # sigma_t = time_scale * sigma_k
    ridge_scale: float = 0.0        # gr = ridge_scale * gs / d
    gamma_scale: float = 1.0        # overall precision multiplier
    gn_steps: int = 20
    damping: float = 1e-4
    grad_tol: float = 1e-5
    init_scale: float = 1e-3
    laplacian: str = "exact"        # 'subset' (parity mode) is not ported
    laplacian_subset_size: int = 5
    parity_fp16: bool = False       # parity mode, not ported
    # Rows per posterior block on the plain (CPU) path; None means 4096.
    # The CUDA kernel bounds its own working set and ignores it.
    eval_chunk: Optional[int] = None
    posterior_backend: str = "auto"
    # 'dense' | 'auto' (dense while phi = 4N + Nb <= dense_phi_max);
    # the distributed trainer is not ported.
    train_backend: str = "auto"
    dense_phi_max: int = 8400
    dist_gn_steps: int = 8
    dist_cg_tol: float = 1e-7
    dist_cg_maxiter: int = 500
