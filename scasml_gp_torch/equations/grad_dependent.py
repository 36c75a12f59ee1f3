"""The gradient-dependent semilinear heat equation with closed-form solution.

Port of ``scasml_gp_tpu/equations/grad_dependent.py``:

    sigma = 0.25
    mu    = -1/d - sigma^2/2
    f(x_t, u, z) = sigma * u * sum(z)
    u*(x, t)     = sigmoid(t + sum_i x_i)
    domain       = [-0.5, 0.5]^d x [0, 0.5]
"""

from __future__ import annotations

import torch

from scasml_gp_torch.equations.base import Equation


def _s(x_t: torch.Tensor) -> torch.Tensor:
    return x_t[:, -1] + torch.sum(x_t[:, :-1], dim=1)


class GradDependentNonlinear(Equation):
    """High-dimensional gradient-dependent semilinear PDE with exact solution."""

    def __init__(self, n_input: int, n_output: int = 1):
        super().__init__(n_input, n_output)
        self.uncertainty = 1e-1
        self.norm_estimation = 1.0

    def sigma(self, x_t=0):
        return 0.25

    def mu(self, x_t=0):
        sigma = self.sigma()
        return -1.0 / self.dim - sigma**2 / 2.0

    def f(self, x_t, u, z):
        return self.sigma() * u * torch.sum(z, dim=1, keepdim=True)

    def terminal_constraint(self, x_t):
        # g(x, t) = sigmoid(t + sum x); at any t it is also the lateral data.
        return torch.sigmoid(_s(x_t))[:, None]

    def exact_solution(self, x_t):
        return torch.sigmoid(_s(x_t))[:, None]

    def exact_solution_derivative(self, x_t):
        p = torch.sigmoid(_s(x_t))
        return (p * (1.0 - p))[:, None]
