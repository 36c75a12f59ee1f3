"""PDE problem protocol and hypercube samplers driven by ``torch.Generator``.

Port of ``scasml_gp_tpu/equations/base.py``.  Conventions are the same:
rows index samples, columns index dimensions, the LAST input column is time,
and ``z`` excludes time.  Every sampler takes the generator it draws from and
the device its result lives on (by default the generator's); nothing reads
global RNG state.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _uniform(gen: torch.Generator, shape, lo: float, hi: float, device, dtype):
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)
    return (lo + (hi - lo) * u).to(device)


class HypercubeGeometry:
    """Axis-aligned hypercube [-radius, radius]^d x [t0, T]."""

    def __init__(self, dim: int, radius: float = 0.5, t0: float = 0.0,
                 T: float = 0.5):
        self.dim = dim
        self.radius = float(radius)
        self.t0 = float(t0)
        self.T = float(T)

    def sample_domain(self, gen: torch.Generator, num: int, device=None,
                      dtype=torch.float32) -> torch.Tensor:
        """Uniform interior points, shape (num, dim + 1)."""
        device = gen.device if device is None else device
        x = _uniform(gen, (num, self.dim), -self.radius, self.radius, device,
                     dtype)
        t = _uniform(gen, (num, 1), self.t0, self.T, device, dtype)
        return torch.cat([x, t], dim=1)

    def sample_terminal(self, gen: torch.Generator, num: int, device=None,
                        dtype=torch.float32) -> torch.Tensor:
        """Uniform points on the terminal surface Omega x {T}."""
        device = gen.device if device is None else device
        x = _uniform(gen, (num, self.dim), -self.radius, self.radius, device,
                     dtype)
        t = torch.full((num, 1), self.T, device=device, dtype=dtype)
        return torch.cat([x, t], dim=1)

    def sample_boundary(self, gen: torch.Generator, num: int, device=None,
                        dtype=torch.float32) -> torch.Tensor:
        """Uniform points on the lateral boundary: a uniformly chosen facet,
        uniform within it, uniform in time."""
        device = gen.device if device is None else device
        x = _uniform(gen, (num, self.dim), -self.radius, self.radius, device,
                     dtype)
        facet = torch.randint(0, self.dim, (num,), generator=gen,
                              device=gen.device).to(device)
        upper = torch.rand((num,), generator=gen, device=gen.device) < 0.5
        side = torch.where(upper.to(device), self.radius, -self.radius)
        onehot = torch.nn.functional.one_hot(facet, self.dim).to(dtype)
        x = x * (1.0 - onehot) + side.to(dtype)[:, None] * onehot
        t = _uniform(gen, (num, 1), self.t0, self.T, device, dtype)
        return torch.cat([x, t], dim=1)


class Equation:
    """Semilinear parabolic PDE on a space-time domain,

        du/dt + <mu, grad u> + (sigma^2/2) Lap u + f(x_t, u, sigma grad u) = 0,
        u(x, T) = g(x).
    """

    def __init__(self, n_input: int, n_output: int = 1):
        self.n_input = int(n_input)
        self.n_output = int(n_output)
        self.dim = self.n_input - 1
        self.t0 = 0.0
        self.T = 0.5
        self.radius = 0.5
        self.uncertainty = 1e-1       # ScaSML residual clip
        self.norm_estimation = 1.0    # MLP output clip
        # 'lateral': the GP's boundary rows lie on the lateral boundary;
        # 'terminal': on the t = T surface.
        self.boundary_mode = "lateral"

    def f(self, x_t, u, z):
        raise NotImplementedError

    def terminal_constraint(self, x_t):
        raise NotImplementedError

    def g(self, x_t):
        return self.terminal_constraint(x_t)

    def mu(self, x_t=0):
        raise NotImplementedError

    def sigma(self, x_t=0):
        raise NotImplementedError

    def exact_solution(self, x_t):
        raise NotImplementedError

    def geometry(self, t0: float = None, T: float = None) -> HypercubeGeometry:
        if t0 is not None:
            self.t0 = float(t0)
        if T is not None:
            self.T = float(T)
        return HypercubeGeometry(self.dim, self.radius, self.t0, self.T)

    test_geometry = geometry

    def _sample(self, geom, gen, num_domain, num_boundary, device, dtype):
        sample_bdy = (
            geom.sample_terminal if self.boundary_mode == "terminal"
            else geom.sample_boundary
        )
        return (
            geom.sample_domain(gen, num_domain, device, dtype),
            sample_bdy(gen, num_boundary, device, dtype),
        )

    def generate_data(
        self, num_domain: int, num_boundary: int, gen: torch.Generator,
        device=None, dtype=torch.float32,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(domain points, boundary points) for training."""
        return self._sample(self.geometry(), gen, num_domain, num_boundary,
                            device, dtype)

    def generate_test_data(
        self, num_domain: int, num_boundary: int, gen: torch.Generator,
        device=None, dtype=torch.float32,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(domain points, boundary points) for testing."""
        return self._sample(self.test_geometry(), gen, num_domain,
                            num_boundary, device, dtype)
