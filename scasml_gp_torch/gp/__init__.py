from scasml_gp_torch.gp.kernels import (
    PHI_OPS,
    PHI_SETS,
    GradCoeffs,
    PairStats,
    grad_coeffs,
    kernel_gamma,
    kernel_gammas,
    op_block,
    pair_stats,
    split_gamma,
)
from scasml_gp_torch.gp.gram import gram_matrix, regularized_factorization
from scasml_gp_torch.gp.posterior import PosteriorOut, posterior_block, posterior_eval
from scasml_gp_torch.gp.state import GPState, load_state, save_state, state_from_numpy
from scasml_gp_torch.gp.solver import (
    GP,
    GPForm,
    GPGradDependentNonlinear,
    GradDependentForm,
)

__all__ = [
    "PHI_OPS",
    "PHI_SETS",
    "GradCoeffs",
    "PairStats",
    "grad_coeffs",
    "kernel_gamma",
    "kernel_gammas",
    "op_block",
    "pair_stats",
    "split_gamma",
    "gram_matrix",
    "regularized_factorization",
    "PosteriorOut",
    "posterior_block",
    "posterior_eval",
    "GPState",
    "load_state",
    "save_state",
    "state_from_numpy",
    "GP",
    "GPForm",
    "GPGradDependentNonlinear",
    "GradDependentForm",
]
