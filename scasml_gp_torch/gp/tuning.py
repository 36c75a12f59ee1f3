"""Grid selection of the GP kernel, judged by ScaSML's own correction.

Port of the dense path of ``scasml_gp_tpu/gp/tuning.py``.  Every candidate
(time_scale, ridge_scale, gamma_scale, nugget) trains at full size through
``GP._train``, and is scored by

    score = mean over fresh interior points of u_breve(X_val)^2,

where ``u_breve`` is the candidate's full-history ScaSML correction: a
Monte-Carlo estimate of the candidate's own error field u - u_hat, which
needs no held-out data.  The judge's generator is reseeded before each
validation set with the same seed for every candidate (common random
numbers), so most of the Monte-Carlo noise cancels from the ranking.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence

import numpy as np
import torch

from scasml_gp_torch.config import GPConfig
from scasml_gp_torch.gp.state import GPState


@dataclasses.dataclass
class TuneResult:
    config: GPConfig
    score: float
    table: list  # [(config, score), ...] over all candidates


def validation_score(gp, x_val_dom, x_val_bdy, boundary_weight: float = 1.0):
    """Out-of-sample PDE residual + boundary mismatch of a trained GP.
    Diagnostic only: it rewards over-smooth kernels, so ``tune_gp`` does not
    select by it."""
    as_np = lambda t: t.detach().cpu().numpy().astype(np.float64).ravel()  # noqa: E731
    eps = as_np(gp.compute_PDE_loss(x_val_dom))
    u_b = as_np(gp.predict(x_val_bdy))
    x_val_bdy = torch.as_tensor(x_val_bdy, dtype=torch.float32, device=gp.device)
    g_b = as_np(gp.equation.g(x_val_bdy))
    return float(np.mean(eps**2) + boundary_weight * np.mean((u_b - g_b) ** 2))


def tune_gp(
    gp_cls,
    equation,
    x_dom,
    x_bdy,
    base: Optional[GPConfig] = None,
    time_scales: Sequence[float] = (1.0,),
    ridge_scales: Sequence[float] = (0.0, 3.0, 10.0, 30.0),
    gamma_scales: Sequence[float] = (1.0,),
    nuggets: Optional[Sequence[float]] = None,
    val_fraction: float = 0.4,
    gn_steps: Optional[int] = None,
    seed: int = 0,
    train_backend: str = "auto",
    judge_n: Optional[int] = None,
    judge_M: int = 8,
    judge_score: str = "energy",
    judge_val_sets: int = 3,
) -> TuneResult:
    """Grid-search the GP kernel on the device of ``x_dom``; candidates train
    at full size and are judged by their own ScaSML correction energy on
    fresh interior points.  Any ``judge_score`` other than 'cross' means
    'energy'.  Returns the winning GPConfig and the score table."""
    from scasml_gp_torch.picard.scasml import ScaSMLFullHistory

    base = base or GPConfig()
    nuggets = nuggets or (base.nugget,)
    if judge_n is None:
        # the n=2 judge mis-ranks at d >= 100; n=3 picks the test optimum
        judge_n = 3 if equation.dim >= 100 else 2
    x_dom = torch.as_tensor(x_dom, dtype=torch.float32)
    dev = x_dom.device
    x_bdy = torch.as_tensor(x_bdy, dtype=torch.float32, device=dev)
    n_dom = x_dom.shape[0]

    gp = gp_cls(equation, base, device=dev)
    if train_backend == "auto":
        gp._check_train_backend(x_dom, x_bdy)
    elif train_backend == "distributed":
        raise NotImplementedError(
            "the distributed (dual-CG) trainer is not ported (ROADMAP Queue 1 F)")
    elif train_backend != "dense":
        raise ValueError(f"unknown train_backend {train_backend!r}")
    steps = base.gn_steps if gn_steps is None else int(gn_steps)
    bg = equation.g(x_bdy)[:, 0].to(torch.float32)
    rhs = gp.form.rhs_f(x_dom).to(torch.float32)

    judge_gp = gp_cls(equation, base, device=dev)
    judge = ScaSMLFullHistory(equation, judge_gp, variance_guard=False)
    geom = equation.geometry()
    n_val = max(64, int(n_dom * val_fraction))
    val_sets = [
        geom.sample_domain(torch.Generator(device=dev).manual_seed(seed + 7 * (i + 1)),
                           n_val, device=dev)
        for i in range(judge_val_sets)
    ]

    def score_one(gamma, nugget):
        rv = gp._train(x_dom, x_bdy, bg, rhs, gamma, nugget, steps,
                       base.damping, base.grad_tol).right_vector
        # A new state per candidate: a state caches the kernel's stacked
        # weights (GPState.fused_inputs), so reusing one would evaluate the
        # previous candidate.
        judge_gp.state = GPState(
            x_dom=x_dom, x_bdy=x_bdy, right_vector=rv,
            sol=torch.zeros((3 * n_dom,), dtype=torch.float32, device=dev),
            gamma=gamma,
            loss_history=torch.zeros((1,), dtype=torch.float32, device=dev),
        )
        total = 0.0
        for si, val_d in enumerate(val_sets):
            # common random numbers: every candidate judges with the same draws
            judge.gen.manual_seed(seed + 101 * (si + 1))
            ub = judge.uz_solve(judge_n, None, val_d, M=judge_M)[:, :1]
            if judge_score == "cross":
                # two independent rollouts: E[ub1 ub2] = (u - u_hat)^2
                judge.gen.manual_seed(seed + 101 * (si + 1) + 53)
                ub2 = judge.uz_solve(judge_n, None, val_d, M=judge_M)[:, :1]
                total += float(torch.mean(ub * ub2))
            else:
                total += float(torch.mean(ub * ub))
        return total / len(val_sets)

    table = []
    best = None
    for ts, rs, gsc, ng in itertools.product(
        time_scales, ridge_scales, gamma_scales, nuggets
    ):
        config = dataclasses.replace(
            base, time_scale=ts, ridge_scale=rs, gamma_scale=gsc, nugget=ng
        )
        gamma = torch.tensor(gp_cls(equation, config, device=dev).gamma,
                             dtype=torch.float32, device=dev)
        score = float(score_one(gamma, float(ng)))
        table.append((config, score))
        if best is None or score < best[1]:
            best = (config, score)

    return TuneResult(config=best[0], score=best[1], table=table)
