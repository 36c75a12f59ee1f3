"""scasml_gp_torch: the PyTorch/CUDA port of scasml_gp_tpu.

SCaSML with a Gaussian-process PDE surrogate, on PyTorch, with the GP
posterior (the hot path of the Picard rollout) in a hand-written CUDA kernel
for Hopper.  The JAX package ``scasml_gp_tpu`` is the reference this port is
checked against; the port never imports it.

- ``equations``  PDE definitions (GradDependentNonlinear, HJB, AllenCahn,
                 SineNonlinear) and torch.Generator-driven samplers.
- ``gp``         closed-form RBF derivative kernels, Gram assembly, the
                 equilibrated float32 Cholesky, damped Newton, the large-N
                 dual-CG trainer (``gp.distributed``), and the posterior
                 (plain PyTorch on the CPU, the CUDA kernel on a GPU); the
                 posterior variance; the Cole-Hopf (HJB) and
                 reaction-semigroup (Allen-Cahn) surrogates.
- ``picard``     static schedules, the quadrature and full-history
                 multilevel Picard recursions, MLP and ScaSML in both variants,
                 with ScaSML's variance guard.
- ``harness``    the runner CLI and the six experiment harnesses;
                 ``gp.tuning`` is the ScaSML-judged kernel tuner and
                 ``gp.marginal`` the marginal-likelihood fit (--fit-ml).
- ``serve``      checkpoints (shared with the JAX package), the bucketed
                 SurrogateServer and its stdlib HTTP front end.
- ``utils``      the nvcc build of ``csrc/*.cu``, the --debug-checks NaN
                 checks, logging and profiling.
"""

import torch as _torch

# The GP cannot take TF32: pair_stats forms r^2 as |x|^2 + |y|^2 - 2 x.y and
# clamps it, and the (4N + Nb)^2 Gram factors in float32 only thanks to
# Jacobi equilibration.  Set once, at import.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from scasml_gp_torch.config import (  # noqa: E402
    GPConfig,
    MeshConfig,
    PicardConfig,
    PrecisionPolicy,
    RunConfig,
)
from scasml_gp_torch.equations import (  # noqa: E402
    EQUATIONS,
    HJB,
    AllenCahn,
    Equation,
    GradDependentNonlinear,
    HypercubeGeometry,
    SineNonlinear,
)
from scasml_gp_torch.gp import (  # noqa: E402
    GP,
    GPAllenCahnSemigroup,
    GPGradDependentNonlinear,
    GPHJBColeHopf,
    GPSineNonlinear,
    GPState,
)
from scasml_gp_torch.picard import (  # noqa: E402
    MLP,
    MLPFullHistory,
    ScaSML,
    ScaSMLFullHistory,
)

__all__ = [
    "GPConfig",
    "MeshConfig",
    "PicardConfig",
    "PrecisionPolicy",
    "RunConfig",
    "EQUATIONS",
    "Equation",
    "GradDependentNonlinear",
    "HJB",
    "AllenCahn",
    "SineNonlinear",
    "HypercubeGeometry",
    "GP",
    "GPGradDependentNonlinear",
    "GPSineNonlinear",
    "GPHJBColeHopf",
    "GPAllenCahnSemigroup",
    "GPState",
    "MLP",
    "MLPFullHistory",
    "ScaSML",
    "ScaSMLFullHistory",
]
