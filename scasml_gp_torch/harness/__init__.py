from scasml_gp_torch.harness.base import HarnessBase
from scasml_gp_torch.harness.metrics import (
    error_metrics,
    paired_t_tests,
    summarize,
    valid_mask,
)
from scasml_gp_torch.harness.simple_uniform import SimpleUniform
from scasml_gp_torch.harness.repeated import RepeatedExperiment
from scasml_gp_torch.harness.runner import (
    HARNESSES,
    build_solvers,
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
    "HARNESSES",
    "build_solvers",
    "run",
    "tuned_config",
]
