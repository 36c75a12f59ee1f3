"""Typed configuration for the PyTorch port.

Same fields and defaults as the JAX package's ``scasml_gp_tpu/config.py``
(``PrecisionPolicy``, ``GPConfig``, ``PicardConfig``, ``MeshConfig``,
``RunConfig``), with dtype properties returning torch dtypes, so a config
written for the JAX package loads unchanged (``RunConfig.from_json``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

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
    # 'subset': the reference's frozen-subset Hutchinson Laplacian (parity
    # mode, gp/parity.py); needs the isotropic kernel
    laplacian: str = "exact"
    laplacian_subset_size: int = 5
    parity_fp16: bool = False       # the reference's fp16 quantization points
    # Rows per posterior block on the plain (CPU) path; None means 4096.
    # The CUDA kernel bounds its own working set and ignores it.
    eval_chunk: Optional[int] = None
    posterior_backend: str = "auto"
    # 'dense' | 'distributed' (the dual-CG trainer, gp/distributed.py) |
    # 'auto' (dense while phi = 4N + Nb <= dense_phi_max, then distributed)
    train_backend: str = "auto"
    dense_phi_max: int = 8400
    dist_gn_steps: int = 8
    dist_cg_tol: float = 1e-7
    dist_cg_maxiter: int = 500


@dataclasses.dataclass(frozen=True)
class PicardConfig:
    """Multilevel Picard solver knobs."""

    n: int = 2                      # recursion depth
    rho: int = 2                    # refinement level (quadrature variant)
    M: int = 3                      # sample base (full-history variant)
    variant: str = "quadrature"     # 'quadrature' | 'full_history'
    batch_chunk: Optional[int] = None  # chunk the test batch to bound memory
    debug_checks: bool = False      # NaN check of every rollout op (utils/debug.py)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout ('data' x 'model' ranks, parallel/mesh.py); larger
    than 1 x 1 runs one process per rank under torchrun."""

    data: int = 1
    model: int = 1

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.data, self.model)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """One experiment run = PDE + dimensions + solvers + harness."""

    equation: str = "GradDependentNonlinear"
    dim: int = 20                   # spatial dimension d (n_input = d + 1)
    num_domain: int = 1000          # GP training set
    num_boundary: int = 200
    test_domain: int = 1000
    test_boundary: int = 200
    seed: int = 1234
    harness: str = "SimpleUniform"
    save_path: str = "results"
    gp: GPConfig = dataclasses.field(default_factory=GPConfig)
    picard: PicardConfig = dataclasses.field(default_factory=PicardConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    precision: PrecisionPolicy = dataclasses.field(default_factory=PrecisionPolicy)
    wandb: bool = False

    @property
    def n_input(self) -> int:
        return self.dim + 1

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "RunConfig":
        raw = json.loads(text)
        for key, cls in (
            ("gp", GPConfig),
            ("picard", PicardConfig),
            ("mesh", MeshConfig),
            ("precision", PrecisionPolicy),
        ):
            if key in raw and isinstance(raw[key], dict):
                raw[key] = cls(**raw[key])
        return RunConfig(**raw)
