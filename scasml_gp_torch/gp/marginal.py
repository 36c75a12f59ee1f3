"""Marginal-likelihood fit of the GP kernel's hyperparameters.

Port of ``scasml_gp_tpu/gp/marginal.py``.  Type-II maximum likelihood over

    theta = (log gamma_scale, log time_scale, raw ridge_scale, log nugget)

minimises the negative log marginal likelihood of the collocation
observations b = [z1, g_bdy, z3, F(z1, z3, z5), z5] under the zero-mean GP
prior with Gram K(theta) + nugget I:

    NLML(theta) = 1/2 b^T (K + nI)^{-1} b + 1/2 log det(K + nI)  (+ const).

b holds the latent collocation values, so the fit alternates, profile
likelihood style:

    repeat OUTER times, for every restart:
        b     <- Newton-trained latents at the current theta (GP._train),
                 detached
        theta <- INNER Adam steps on NLML(theta; b)

Gradients flow through the Gram assembly, the equilibration, the Cholesky
and the triangular solve (gram.logdet_quad).  The restarts run one after
another in a Python loop, where the JAX package batches them with ``vmap``.

Two guards keep the profile approximation honest (unconstrained, the fit
drifts to degenerate kernels): the objective is MAP, a Gaussian prior in
theta around each restart's initial point (``prior_strength``), with the
nugget frozen unless ``learn_nugget``; and the shipped config is chosen by
the ScaSML judge of gp/tuning.py among {base, seed configs, fitted
candidates}, a fitted candidate displacing the best anchor only when it
scores below 0.9 x the anchor's score.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from scasml_gp_torch.config import GPConfig
from scasml_gp_torch.gp.gram import gram_matrix, logdet_quad
from scasml_gp_torch.gp.kernels import kernel_gammas
from scasml_gp_torch.gp.tuning import scasml_judge

_SOFTPLUS_CAP = 30.0


@dataclasses.dataclass
class MarginalFitResult:
    config: GPConfig            # validation-selected, ready-to-use GPConfig
    nlml: float                 # its final negative log marginal likelihood
    table: list                 # [(GPConfig, nlml, val_score), ...] incl. base
    history: np.ndarray         # (outer_rounds, n_restarts) NLML after each round


def _theta_to_params(theta: torch.Tensor):
    """Unconstrained theta -> (gamma_scale, time_scale, ridge_scale, nugget)."""
    raw = torch.clamp_max(theta[2], _SOFTPLUS_CAP)
    return (torch.exp(theta[0]), torch.exp(theta[1]),
            torch.logaddexp(raw, torch.zeros_like(raw)), torch.exp(theta[3]))


def _params_to_theta(gamma_scale, time_scale, ridge_scale, nugget) -> np.ndarray:
    # inverse softplus; ridge_scale=0 maps to a large negative raw value
    rr = np.asarray(ridge_scale, np.float64)
    raw = np.where(rr > 1e-6, np.log(np.expm1(np.maximum(rr, 1e-6))), -14.0)
    return np.array(
        [np.log(gamma_scale), np.log(time_scale), raw, np.log(nugget)],
        np.float32,
    )


def _gamma_of(theta: torch.Tensor, eq_sigma: float, dim: int) -> torch.Tensor:
    """(gs, gt, gr) of theta as a (3,) tensor that carries theta's gradient."""
    c, ts, rr, _ = _theta_to_params(theta)
    gs0, _, _ = kernel_gammas(eq_sigma, dim)  # host floats
    gs = gs0 * c
    gt = gs / (ts * ts)
    gr = rr * gs / dim
    return torch.stack([gs, gt, gr])


def _nlml(theta, b, x_dom, x_bdy, eq_sigma: float, dim: int) -> torch.Tensor:
    """NLML(theta; b) up to its constant."""
    K = gram_matrix(x_dom, x_bdy, _gamma_of(theta, eq_sigma, dim), dim)
    logdet, quad = logdet_quad(K, _theta_to_params(theta)[3], b)
    return 0.5 * (quad + logdet)


def _descend(theta, anchor, nlml_of, steps: int, lr: float,
             prior_strength: float, grad_mask) -> torch.Tensor:
    """``steps`` Adam steps on the MAP objective
    nlml_of(theta) + prior_strength / 2 ||theta - anchor||^2 from ``theta``,
    with a fresh optimizer (optax.adam's update); a non-finite gradient entry
    counts as 0 and ``grad_mask`` zeroes the frozen entries."""
    theta = theta.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([theta], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        obj = nlml_of(theta) + 0.5 * prior_strength * torch.sum((theta - anchor) ** 2)
        obj.backward()
        g = theta.grad
        theta.grad = torch.where(torch.isfinite(g), g, torch.zeros_like(g)) * grad_mask
        opt.step()
    return theta.detach()


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
    """Fit (gamma_scale, time_scale, ridge_scale[, nugget]) by MAP NLML
    descent on the device of ``x_dom``; returns the judge-selected GPConfig
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
    N = x_dom.shape[0]
    dim = equation.dim
    eq_sigma = float(equation.sigma())
    steps = base.gn_steps if gn_steps is None else int(gn_steps)

    theta0 = [_params_to_theta(base.gamma_scale, base.time_scale, rs, base.nugget)
              for rs in init_ridge_scales]
    theta0 += [_params_to_theta(cfg.gamma_scale, cfg.time_scale, cfg.ridge_scale,
                                cfg.nugget) for cfg in seed_configs]
    if len(theta0) == 5:
        # The JAX package adds a jittered sixth restart at exactly 5, to dodge
        # a TPU runtime fault of its batched trainer; kept so that the
        # candidate table has the JAX package's rows.
        theta0.append(theta0[-1] + np.array([0.05, 0.0, 0.0, 0.0], np.float32))
    theta0 = [torch.as_tensor(t, device=dev) for t in theta0]
    grad_mask = torch.tensor([1.0, 1.0, 1.0, 1.0 if learn_nugget else 0.0],
                             dtype=torch.float32, device=dev)

    def b_of(theta):
        """The detached collocation observations of a Newton train at theta."""
        with torch.no_grad():
            gamma = _gamma_of(theta, eq_sigma, dim)
            nugget = _theta_to_params(theta)[3]
            sol = gp._train(x_dom, x_bdy, bdy_g, rhs, gamma, nugget, steps,
                            base.damping, base.grad_tol).sol
            z1, z3, z5 = sol[:N], sol[N:2 * N], sol[2 * N:]
            return torch.cat([z1, bdy_g, z3, gp.form.F(z1, z3, z5, rhs), z5])

    history = []
    theta = list(theta0)
    for _ in range(outer_rounds):
        bs = [b_of(t) for t in theta]
        final = []
        for i, b in enumerate(bs):
            def nlml_of(t, b=b):
                return _nlml(t, b, x_dom, x_bdy, eq_sigma, dim)

            theta[i] = _descend(theta[i], theta0[i], nlml_of, inner_steps, lr,
                                prior_strength, grad_mask)
            with torch.no_grad():
                final.append(float(nlml_of(theta[i])))  # b fixed in the round
        history.append(np.asarray(final, np.float64))

    candidates = [(base, float("nan"))]
    # the raw seed configs compete untouched, so a seed (e.g. the grid
    # winner) is displaced only by a candidate that scores better
    candidates += [(cfg, float("nan")) for cfg in seed_configs]
    for t, score in zip(theta, history[-1]):
        c, ts, rr, ng = (float(v) for v in _theta_to_params(t))
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
