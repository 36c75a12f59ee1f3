from scasml_gp_torch.picard.schedule import (
    PicardTables,
    approx_parameters,
    count_evaluations_full_history,
    count_evaluations_quadrature,
    inverse_gamma,
    leggauss,
)
from scasml_gp_torch.picard.core import PicardModel, build_quadrature_uz
from scasml_gp_torch.picard.mlp import MLP
from scasml_gp_torch.picard.scasml import ScaSML

__all__ = [
    "PicardTables",
    "approx_parameters",
    "count_evaluations_full_history",
    "count_evaluations_quadrature",
    "inverse_gamma",
    "leggauss",
    "PicardModel",
    "build_quadrature_uz",
    "MLP",
    "ScaSML",
]
