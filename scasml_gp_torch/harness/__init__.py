from scasml_gp_torch.harness.base import HarnessBase
from scasml_gp_torch.harness.metrics import (
    error_metrics,
    paired_t_tests,
    summarize,
    valid_mask,
)
from scasml_gp_torch.harness.simple_uniform import SimpleUniform
from scasml_gp_torch.harness.repeated import RepeatedExperiment
from scasml_gp_torch.harness.convergence_rate import ConvergenceRate
from scasml_gp_torch.harness.inference_scaling import InferenceScaling
from scasml_gp_torch.harness.simple_scaling import SimpleScaling
from scasml_gp_torch.harness.computing_budget import ComputingBudget
from scasml_gp_torch.harness.runner import (
    HARNESSES,
    build_solvers,
    fitted_config,
    run,
    tuned_config,
)

__all__ = [
    "HarnessBase",
    "error_metrics",
    "paired_t_tests",
    "summarize",
    "valid_mask",
    "SimpleUniform",
    "RepeatedExperiment",
    "ConvergenceRate",
    "InferenceScaling",
    "SimpleScaling",
    "ComputingBudget",
    "HARNESSES",
    "build_solvers",
    "fitted_config",
    "run",
    "tuned_config",
]
