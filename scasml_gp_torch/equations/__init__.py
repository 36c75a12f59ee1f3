from scasml_gp_torch.equations.base import Equation, HypercubeGeometry
from scasml_gp_torch.equations.grad_dependent import GradDependentNonlinear

__all__ = ["Equation", "HypercubeGeometry", "GradDependentNonlinear"]
