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
    AllenCahnForm,
    GPAllenCahn,
    GPForm,
    GPGradDependentNonlinear,
    GPSineNonlinear,
    GradDependentForm,
    SineForm,
)
from scasml_gp_torch.gp.cole_hopf import GPHJBColeHopf
from scasml_gp_torch.gp.semigroup import GPAllenCahnSemigroup
from scasml_gp_torch.gp.variance import (
    cross_phi,
    factor_for_variance,
    posterior_variance,
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
    "GradDependentForm",
    "AllenCahnForm",
    "SineForm",
    "GPGradDependentNonlinear",
    "GPAllenCahn",
    "GPSineNonlinear",
    "GPHJBColeHopf",
    "GPAllenCahnSemigroup",
    "cross_phi",
    "factor_for_variance",
    "posterior_variance",
]
