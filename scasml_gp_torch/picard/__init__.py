from scasml_gp_torch.picard.schedule import (
    PicardTables,
    approx_parameters,
    count_evaluations_full_history,
    count_evaluations_quadrature,
    inverse_gamma,
    leggauss,
)
from scasml_gp_torch.picard.core import (
    PicardModel,
    build_full_history_uz,
    build_quadrature_uz,
)
from scasml_gp_torch.picard.mlp import MLP, MLP_full_history, MLPFullHistory
from scasml_gp_torch.picard.scasml import (
    ScaSML,
    ScaSML_full_history,
    ScaSMLFullHistory,
)

__all__ = [
    "PicardTables",
    "approx_parameters",
    "count_evaluations_full_history",
    "count_evaluations_quadrature",
    "inverse_gamma",
    "leggauss",
    "PicardModel",
    "build_full_history_uz",
    "build_quadrature_uz",
    "MLP",
    "MLPFullHistory",
    "MLP_full_history",
    "ScaSML",
    "ScaSMLFullHistory",
    "ScaSML_full_history",
]
