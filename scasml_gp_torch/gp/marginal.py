"""Marginal-likelihood fit of the GP kernel's hyperparameters.

Port of ``scasml_gp_tpu/gp/marginal.py``.  Type-II maximum likelihood over

    theta = (log gamma_scale, log time_scale, raw ridge_scale, log nugget)

minimises the negative log marginal likelihood of the collocation
observations b = [z1, g_bdy, z3, F(z1, z3, z5), z5] under the zero-mean GP
prior with Gram K(theta) + nugget I:

    NLML(theta) = 1/2 b^T (K + nI)^{-1} b + 1/2 log det(K + nI)  (+ const).

b holds the latent collocation values, so the fit alternates, profile
likelihood style:

    repeat OUTER times, every restart at once:
        b     <- Newton-trained latents at the current theta (GP._train),
                 detached
        theta <- INNER Adam steps on NLML(theta; b)

The restarts advance together on a leading axis R, as the JAX package's
``jax.vmap`` inside one ``jax.jit`` (``outer_round``) advances them: one
batched Gram (R, phi, phi), one batched Newton train and one batched Adam
per round.  Gradients flow through the Gram assembly, the equilibration,
the Cholesky and the triangular solve (gram.logdet_quad).  On a CUDA device
an Adam step is captured once per fit as a CUDA graph (picard/graphs.py):
the first round runs eagerly and warms the solver libraries up, the second
captures the step, and every later step replays it with the round's theta,
b and fresh moments copied into the graph's buffers.  A failed capture
raises; ``_eager()`` keeps the steps eager for an A/B.

Two guards keep the profile approximation honest (unconstrained, the fit
drifts to degenerate kernels): the objective is MAP, a Gaussian prior in
theta around each restart's initial point (``prior_strength``), with the
nugget frozen unless ``learn_nugget``; and the shipped config is chosen by
the ScaSML judge of gp/tuning.py among {base, seed configs, fitted
candidates}, a fitted candidate displacing the best anchor only when it
scores below 0.9 x the anchor's score.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from scasml_gp_torch.config import GPConfig
from scasml_gp_torch.gp.gram import gram_matrix, logdet_quad
from scasml_gp_torch.gp.kernels import kernel_gammas
from scasml_gp_torch.gp.tuning import scasml_judge
from scasml_gp_torch.picard import graphs

_SOFTPLUS_CAP = 30.0
_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults
_eager_only = False
# The capture step of the Adam graph: graphs.capture_graph on the card; the
# CPU tests put an eager stand-in here.
_capture = graphs.capture_graph


@dataclasses.dataclass
class MarginalFitResult:
    config: GPConfig            # validation-selected, ready-to-use GPConfig
    nlml: float                 # its final negative log marginal likelihood
    table: list                 # [(GPConfig, nlml, val_score), ...] incl. base
    history: np.ndarray         # (outer_rounds, n_restarts) NLML after each round


def _theta_to_params(theta: torch.Tensor):
    """Unconstrained theta (..., 4) -> (gamma_scale, time_scale,
    ridge_scale, nugget), each of theta's leading shape."""
    raw = torch.clamp_max(theta[..., 2], _SOFTPLUS_CAP)
    return (torch.exp(theta[..., 0]), torch.exp(theta[..., 1]),
            torch.logaddexp(raw, torch.zeros_like(raw)), torch.exp(theta[..., 3]))


def _params_to_theta(gamma_scale, time_scale, ridge_scale, nugget) -> np.ndarray:
    # inverse softplus; ridge_scale=0 maps to a large negative raw value
    rr = np.asarray(ridge_scale, np.float64)
    raw = np.where(rr > 1e-6, np.log(np.expm1(np.maximum(rr, 1e-6))), -14.0)
    return np.array(
        [np.log(gamma_scale), np.log(time_scale), raw, np.log(nugget)],
        np.float32,
    )


def _initial_thetas(base: GPConfig, init_ridge_scales: Sequence[float],
                    seed_configs: Sequence[GPConfig]) -> np.ndarray:
    """The restarts' initial thetas (R, 4): one per ridge scale at
    ``base``'s other parameters, then one per seed config."""
    theta0 = [_params_to_theta(base.gamma_scale, base.time_scale, rs, base.nugget)
              for rs in init_ridge_scales]
    theta0 += [_params_to_theta(cfg.gamma_scale, cfg.time_scale, cfg.ridge_scale,
                                cfg.nugget) for cfg in seed_configs]
    if len(theta0) == 5:
        # The JAX package adds a jittered sixth restart at exactly 5, to dodge
        # a TPU runtime fault of its batched trainer; kept so that the
        # candidate table has the JAX package's rows.
        theta0.append(theta0[-1] + np.array([0.05, 0.0, 0.0, 0.0], np.float32))
    return np.stack(theta0)


def _gamma_of(theta: torch.Tensor, eq_sigma: float, dim: int) -> torch.Tensor:
    """(gs, gt, gr) of theta (..., 4) as a (..., 3) tensor that carries
    theta's gradient."""
    c, ts, rr, _ = _theta_to_params(theta)
    gs0, _, _ = kernel_gammas(eq_sigma, dim)  # host floats
    gs = gs0 * c
    gt = gs / (ts * ts)
    gr = rr * gs / dim
    return torch.stack([gs, gt, gr], dim=-1)


def _nlml(theta, b, x_dom, x_bdy, eq_sigma: float, dim: int) -> torch.Tensor:
    """NLML(theta; b) up to its constant; theta (R, 4) and b (R, phi) give
    one value per restart."""
    K = gram_matrix(x_dom, x_bdy, _gamma_of(theta, eq_sigma, dim), dim)
    logdet, quad = logdet_quad(K, _theta_to_params(theta)[3], b)
    return 0.5 * (quad + logdet)


def _train_latents(gp, theta, x_dom, x_bdy, bdy_g, rhs, eq_sigma: float,
                   steps: int, base: GPConfig) -> torch.Tensor:
    """The detached collocation observations b (R, phi) of one batched
    Newton train at every restart's theta (R, 4)."""
    N, dim = x_dom.shape[0], gp.d
    with torch.no_grad():
        sol = gp._train(x_dom, x_bdy, bdy_g, rhs, _gamma_of(theta, eq_sigma, dim),
                        _theta_to_params(theta)[3], steps, base.damping,
                        base.grad_tol).sol
        z1, z3, z5 = sol[:, :N], sol[:, N:2 * N], sol[:, 2 * N:]
        return torch.cat([z1, bdy_g.expand(sol.shape[0], -1), z3,
                          gp.form.F(z1, z3, z5, rhs), z5], dim=-1)


def eager_reason(device) -> Optional[str]:
    """Why the fit's Adam steps on ``device`` run eagerly, or None when they
    replay a captured CUDA graph."""
    if _eager_only:
        return "eager on request (_eager)"
    return graphs.eager_reason(device)


@contextlib.contextmanager
def _eager():
    """Run the fit's Adam steps eagerly inside the block: the A/B of
    chip_smoke.py and the CUDA tests against the captured graph."""
    global _eager_only
    _eager_only = True
    try:
        yield
    finally:
        _eager_only = False


class _MapAdam:
    """``steps`` Adam steps a round on the batched MAP objective

        nlml_of(theta, b) + prior_strength / 2 ||theta - anchor||^2

    (one value per restart), written in optax.adam's form on the batch:
    moments fresh each round, the gradient of the summed objective (each
    restart's own, the restarts being independent), a non-finite entry
    counted as 0 and ``grad_mask`` zeroing the frozen entries.  theta, b,
    the moments and the step count live in buffers of this object; with
    ``graphed`` the first round runs eagerly, the second captures one step
    (``_capture``) and every later step replays it."""

    def __init__(self, nlml_of: Callable, anchor: torch.Tensor, steps: int, lr: float,
                 prior_strength: float, grad_mask: torch.Tensor, graphed: bool):
        self.nlml_of, self.anchor, self.steps, self.lr = nlml_of, anchor, steps, lr
        self.prior_strength, self.grad_mask, self.graphed = prior_strength, grad_mask, graphed
        self.theta = anchor.detach().clone().requires_grad_(True)
        self.b = None
        self.mu = torch.zeros_like(anchor)
        self.nu = torch.zeros_like(anchor)
        self.count = torch.zeros((), dtype=anchor.dtype, device=anchor.device)
        self.graph = None
        self.rounds = 0

    def _step(self) -> None:
        prior = 0.5 * self.prior_strength * torch.sum((self.theta - self.anchor) ** 2, dim=-1)
        obj = self.nlml_of(self.theta, self.b) + prior
        (g,) = torch.autograd.grad(obj.sum(), self.theta)
        with torch.no_grad():
            g = torch.where(torch.isfinite(g), g, torch.zeros_like(g)) * self.grad_mask
            self.mu.copy_((1 - _B1) * g + _B1 * self.mu)
            self.nu.copy_((1 - _B2) * (g * g) + _B2 * self.nu)
            self.count += 1
            mu_hat = self.mu / (1 - torch.pow(_B1, self.count))
            nu_hat = self.nu / (1 - torch.pow(_B2, self.count))
            self.theta += mu_hat / (torch.sqrt(nu_hat) + _EPS) * -self.lr

    def __call__(self, theta: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """One round from ``theta`` (R, 4) with the latents ``b`` (R, phi)
        fixed; returns the descended theta."""
        with torch.no_grad():
            if self.b is None:
                self.b = torch.empty_like(b)
            self.theta.copy_(theta)
            self.b.copy_(b)
            self.mu.zero_()
            self.nu.zero_()
            self.count.zero_()
        if self.graphed and self.rounds > 0:
            if self.graph is None:
                self.graph = _capture(self._step, what="the fit's Adam step")
            for _ in range(self.steps):
                self.graph.replay()
        else:
            for _ in range(self.steps):
                self._step()
        self.rounds += 1
        return self.theta.detach().clone()

    def close(self) -> None:
        """Free the graph and its memory pool."""
        if self.graph is not None:
            self.graph.close()
            self.graph = None


def fit_gp_marginal_likelihood(
    gp_cls,
    equation,
    x_dom,
    x_bdy,
    base: Optional[GPConfig] = None,
    init_ridge_scales: Sequence[float] = (0.0, 3.0, 10.0, 30.0),
    outer_rounds: int = 3,
    inner_steps: int = 30,
    lr: float = 0.08,
    gn_steps: Optional[int] = None,
    learn_nugget: bool = False,
    prior_strength: float = 2.0,
    val_fraction: float = 0.4,
    seed: int = 0,
    seed_configs: Sequence[GPConfig] = (),
) -> MarginalFitResult:
    """Fit (gamma_scale, time_scale, ridge_scale[, nugget]) by batched MAP
    NLML descent on the device of ``x_dom``; returns the judge-selected GPConfig
    (train a fresh ``gp_cls`` with it).

    ``init_ridge_scales`` seeds one restart per value, every other parameter
    at ``base``'s.  ``prior_strength`` is the precision of the log-space
    Gaussian prior around each restart's initial theta (0 disables it).
    ``seed_configs`` adds one restart from each of those configs, and enters
    the configs themselves, untouched, into the candidate table, so the
    returned config never scores worse than a seed (e.g. the grid winner).
    """
    base = base or GPConfig()
    x_dom = torch.as_tensor(x_dom, dtype=torch.float32)
    dev = x_dom.device
    x_bdy = torch.as_tensor(x_bdy, dtype=torch.float32, device=dev)
    gp = gp_cls(equation, base, device=dev)  # the Newton trainer and form
    bdy_g = equation.g(x_bdy)[:, 0].to(torch.float32)
    rhs = gp.form.rhs_f(x_dom).to(torch.float32)
    dim = equation.dim
    eq_sigma = float(equation.sigma())
    steps = base.gn_steps if gn_steps is None else int(gn_steps)

    theta0 = torch.as_tensor(_initial_thetas(base, init_ridge_scales, seed_configs),
                             device=dev)
    grad_mask = torch.tensor([1.0, 1.0, 1.0, 1.0 if learn_nugget else 0.0],
                             dtype=torch.float32, device=dev)
    adam = _MapAdam(lambda t, b: _nlml(t, b, x_dom, x_bdy, eq_sigma, dim), theta0,
                    inner_steps, lr, prior_strength, grad_mask,
                    graphed=eager_reason(dev) is None)
    history = []
    theta = theta0
    try:
        for _ in range(outer_rounds):
            b = _train_latents(gp, theta, x_dom, x_bdy, bdy_g, rhs, eq_sigma, steps, base)
            theta = adam(theta, b)
            with torch.no_grad():  # b fixed in the round; one host read a round
                final = _nlml(theta, b, x_dom, x_bdy, eq_sigma, dim)
            history.append(final.cpu().numpy().astype(np.float64))
    finally:
        adam.close()

    candidates = [(base, float("nan"))]
    # the raw seed configs compete untouched, so a seed (e.g. the grid
    # winner) is displaced only by a candidate that scores better
    candidates += [(cfg, float("nan")) for cfg in seed_configs]
    params = torch.stack(_theta_to_params(theta), dim=-1).cpu()
    for row, score in zip(params, history[-1]):
        c, ts, rr, ng = (float(v) for v in row)
        cfg = dataclasses.replace(
            base, gamma_scale=c, time_scale=ts, ridge_scale=rr,
            nugget=ng if learn_nugget else base.nugget,
        )
        candidates.append((cfg, float(score)))

    # Every candidate is judged by the energy of its own ScaSML correction,
    # as in gp/tuning.py: the fit proposes, the judge ships.
    judge = scasml_judge(gp_cls, equation, base, x_dom, x_bdy, steps, seed=seed,
                         val_fraction=val_fraction)
    table = []
    for cfg, nlml_val in candidates:
        gamma = torch.tensor(gp_cls(equation, cfg, device=dev).gamma,
                             dtype=torch.float32, device=dev)
        table.append((cfg, nlml_val, judge(gamma, cfg.nugget)))
    # anchored selection: a descended candidate displaces the anchors (base
    # and the seed configs, the first 1 + len(seed_configs) rows) only by
    # beating the best anchor by a clear margin
    n_anchor = 1 + len(seed_configs)
    best_anchor = min(range(n_anchor), key=lambda i: table[i][2])
    best = min(range(len(table)), key=lambda i: table[i][2])
    if best >= n_anchor and not table[best][2] < 0.9 * table[best_anchor][2]:
        best = best_anchor

    return MarginalFitResult(
        config=table[best][0],
        nlml=table[best][1],
        table=table,
        history=np.stack(history),
    )
