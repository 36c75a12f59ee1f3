"""scasml_gp_torch: the PyTorch/CUDA port of scasml_gp_tpu.

SCaSML with a Gaussian-process PDE surrogate, on PyTorch, with the GP
posterior (the hot path of the Picard rollout) in a hand-written CUDA kernel
for Hopper.  The JAX package ``scasml_gp_tpu`` is the reference this port is
checked against; the port never imports it.

- ``equations``  PDE definitions and torch.Generator-driven samplers.
- ``gp``         closed-form RBF derivative kernels, Gram assembly, the
                 equilibrated float32 Cholesky, damped Newton, and the
                 posterior (plain PyTorch on the CPU, the CUDA kernel on a GPU).
- ``picard``     static schedules, the quadrature multilevel Picard
                 recursion, MLP and ScaSML.
- ``utils``      the nvcc build of ``csrc/*.cu``.
"""

import torch as _torch

# The GP cannot take TF32: pair_stats forms r^2 as |x|^2 + |y|^2 - 2 x.y and
# clamps it, and the (4N + Nb)^2 Gram factors in float32 only thanks to
# Jacobi equilibration.  Set once, at import.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from scasml_gp_torch.config import GPConfig, PrecisionPolicy  # noqa: E402
from scasml_gp_torch.equations import (  # noqa: E402
    Equation,
    GradDependentNonlinear,
    HypercubeGeometry,
)
from scasml_gp_torch.gp import GP, GPGradDependentNonlinear, GPState  # noqa: E402
from scasml_gp_torch.picard import MLP, ScaSML  # noqa: E402

__all__ = [
    "GPConfig",
    "PrecisionPolicy",
    "Equation",
    "GradDependentNonlinear",
    "HypercubeGeometry",
    "GP",
    "GPGradDependentNonlinear",
    "GPState",
    "MLP",
    "ScaSML",
]
