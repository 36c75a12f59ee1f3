"""The three PDE families beyond GradDependentNonlinear.

Port of ``scasml_gp_tpu/equations/extra.py``: HJB (with its Cole-Hopf
Monte-Carlo exact solution), SineNonlinear (a manufactured closed-form
solution with an explicit x_t forcing) and Allen-Cahn (no closed form; the
harness falls back to a deep Picard reference).  The estimator flags each
equation sets (``center_z``, ``time_sampling``, ``terminal_z``,
``variance_guard``, ``escalate_M*``, ``boundary_mode``) are read by the
Picard solvers and the GP samplers exactly as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from scasml_gp_torch.equations.base import Equation


class HJB(Equation):
    """Hamilton-Jacobi-Bellman: u_t + Lap u - |grad u|^2 = 0 on [0, T],
    u(x, T) = ln((1 + |x|^2)/2).  Exact solution via Cole-Hopf:
    u(t, x) = -ln E[exp(-g(x + sqrt(2) W_{T-t}))]."""

    def __init__(self, n_input: int, n_output: int = 1):
        super().__init__(n_input, n_output)
        # -|grad u|^2 is gradient-quadratic: the raw z estimator's variance
        # enters the mean of f, so the centered estimators are needed.
        self.center_z = True
        self.time_sampling = "sqrt"
        self.terminal_z = "corrected"
        # The James-Stein variance guard (picard/scasml.py) shrinks or
        # abstains when the correction is noise; escalate_M lets its probe
        # pick a schedule from a shallow-first ladder.
        self.variance_guard = True
        self.escalate_M = True
        self.escalate_M_accept = 0.5
        self.escalate_M_max = 12
        # |u| grows like ln(d) on the diffusion-reachable set, so the output
        # clips scale with dimension.
        d = n_input - 1
        self.norm_estimation = 1.0 + math.log1p(d)
        self.uncertainty = 0.25 * self.norm_estimation
        # g is the terminal condition only: boundary rows live on t = T.
        self.boundary_mode = "terminal"

    def sigma(self, x_t=0):
        return math.sqrt(2.0)

    def mu(self, x_t=0):
        return 0.0

    def f(self, x_t, u, z):
        # -|grad u|^2 = -|z|^2 / sigma^2 with z = sigma grad u
        return -torch.sum(z * z, dim=1, keepdim=True) / self.sigma() ** 2

    def terminal_constraint(self, x_t):
        x = x_t[:, :-1]
        return torch.log(0.5 * (1.0 + torch.sum(x * x, dim=1)))[:, None]

    def terminal_bernstein_v(self):
        """(a, b) of the log-rational terminal form g = ln((1 + b|x|^2)/a):
        v_T = e^{-k g} = a^k (1 + b q)^{-k} is completely monotone in
        q = |x|^2, so it is an exact Gaussian mixture (gp/cole_hopf.py)."""
        return (2.0, 1.0)

    def exact_solution(self, x_t, gen: torch.Generator = None,
                       num_mc: int = 32768, mc_chunk: int = 512):
        """Cole-Hopf MC: u = -ln E[exp(-g(x + sqrt(2) W_{T-t}))].

        Accumulated over ``mc_chunk``-sample slices with a running max for
        the log-mean-exp, so the peak buffer is (n, mc_chunk, d).  ``gen``
        defaults to a generator on x_t's device seeded with 7."""
        if gen is None:
            gen = torch.Generator(device=x_t.device).manual_seed(7)
        x = x_t[:, :-1].to(torch.float32)
        t = x_t[:, -1].to(torch.float32)
        n = x.shape[0]
        scale = torch.sqrt(2.0 * torch.clamp_min(self.T - t, 0.0))[:, None, None]
        n_chunks = max(1, -(-num_mc // mc_chunk))
        m = torch.full((n,), -math.inf, dtype=torch.float32, device=x.device)
        acc = torch.zeros((n,), dtype=torch.float32, device=x.device)
        for _ in range(n_chunks):
            w = torch.randn((n, mc_chunk, self.dim), generator=gen,
                            device=gen.device, dtype=torch.float32).to(x.device)
            xs = x[:, None, :] + scale * w
            neg_g = -torch.log(0.5 * (1.0 + torch.sum(xs * xs, dim=2)))
            m_new = torch.maximum(m, torch.amax(neg_g, dim=1))
            acc = acc * torch.exp(m - m_new) + torch.sum(
                torch.exp(neg_g - m_new[:, None]), dim=1)
            m = m_new
        lme = torch.log(acc / (n_chunks * mc_chunk)) + m
        return (-lme)[:, None]


class SineNonlinear(Equation):
    """Semilinear sine benchmark with a manufactured closed-form solution:

        u_t + mu sum_i u_xi + (sigma^2/2) Lap u + f(x_t, u, sigma grad u) = 0,
        f(x_t, u, z) = sin(u) + (1/d) sum_i z_i + R(x_t),
        mu = -1/(2d),  sigma = 0.25,  on [-0.5, 0.5]^d x [0, 0.5],

    with the forcing R chosen so that u*(x, t) = sin(t + mean_i x_i)."""

    def __init__(self, n_input: int, n_output: int = 1):
        super().__init__(n_input, n_output)
        self.norm_estimation = 2.0
        self.uncertainty = 1e-1

    def sigma(self, x_t=0):
        return 0.25

    def mu(self, x_t=0):
        return -0.5 / self.dim

    def _phase(self, x_t: torch.Tensor) -> torch.Tensor:
        """s = t + (1/d) sum_i x_i, shape (batch,)."""
        return x_t[:, -1] + torch.mean(x_t[:, :-1], dim=1)

    def forcing(self, x_t: torch.Tensor) -> torch.Tensor:
        """R(x_t), shape (batch,):
        R = -(1 + mu + sigma/d) cos s + (sigma^2/(2d)) sin s - sin(sin s)."""
        s = self._phase(x_t)
        sig, mu, d = self.sigma(), self.mu(), self.dim
        return (
            -(1.0 + mu + sig / d) * torch.cos(s)
            + (sig**2 / (2.0 * d)) * torch.sin(s)
            - torch.sin(torch.sin(s))
        )

    def f(self, x_t, u, z):
        return (torch.sin(u) + torch.mean(z, dim=1, keepdim=True)
                + self.forcing(x_t)[:, None])

    def terminal_constraint(self, x_t):
        # the exact solution holds at any (x, t): lateral boundary rows
        return self.exact_solution(x_t)

    def exact_solution(self, x_t):
        return torch.sin(self._phase(x_t))[:, None]

    def exact_solution_derivative(self, x_t):
        s = self._phase(x_t)
        return (torch.cos(s) / self.dim)[:, None].expand(x_t.shape[0], self.dim)


class AllenCahn(Equation):
    """Allen-Cahn: u_t + Lap u + u - u^3 = 0, u(x, T) = 1/(2 + 0.4 |x|^2)."""

    def __init__(self, n_input: int, n_output: int = 1):
        super().__init__(n_input, n_output)
        self.T = 0.3
        self.uncertainty = 5e-1
        self.norm_estimation = 2.0
        self.boundary_mode = "terminal"  # u = g holds exactly only at t = T

    def sigma(self, x_t=0):
        return math.sqrt(2.0)

    def mu(self, x_t=0):
        return 0.0

    def f(self, x_t, u, z):
        return u - u**3

    def terminal_constraint(self, x_t):
        x = x_t[:, :-1]
        return (1.0 / (2.0 + 0.4 * torch.sum(x * x, dim=1)))[:, None]

    def terminal_bernstein(self):
        """(a, b) of the completely monotone radial terminal form
        g = 1/(a + b |x|^2), an exact mixture of origin-centered Gaussians
        (gp/semigroup.py)."""
        return (2.0, 0.4)

    def exact_solution(self, x_t):
        raise NotImplementedError(
            "Allen-Cahn has no closed form; use a high-level Picard run as the "
            "reference (harness.metrics.mc_reference_solution)."
        )
