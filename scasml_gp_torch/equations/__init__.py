from scasml_gp_torch.equations.base import Equation, HypercubeGeometry
from scasml_gp_torch.equations.grad_dependent import GradDependentNonlinear
from scasml_gp_torch.equations.extra import AllenCahn, HJB, SineNonlinear

EQUATIONS = {
    "GradDependentNonlinear": GradDependentNonlinear,
    "AllenCahn": AllenCahn,
    "HJB": HJB,
    "SineNonlinear": SineNonlinear,
}

__all__ = [
    "Equation",
    "HypercubeGeometry",
    "GradDependentNonlinear",
    "AllenCahn",
    "HJB",
    "SineNonlinear",
    "EQUATIONS",
]
