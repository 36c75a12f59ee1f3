"""Multilevel Picard recursion over static schedules.

Port of ``scasml_gp_tpu/picard/core.py``: the quadrature variant, over the
(n, rho) tables of :mod:`scasml_gp_torch.picard.schedule`, and the
full-history variant, over sample counts M^k.  The recursion runs eagerly in
Python, and the quadrature-point scan is a Python loop.  Every draw comes
from the ``torch.Generator`` the caller passes in, taken in sequence: each
tree node gets fresh numbers and no seed is reused across nodes.  Results
match the JAX package in distribution, not bit for bit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from scasml_gp_torch.config import DTYPES
from scasml_gp_torch.picard.schedule import PicardTables

_TERMINAL_MC_CHUNK = 1024  # bounds (B * chunk * dim) terminal buffers


class PicardModel(NamedTuple):
    """Problem spec consumed by the recursion builders; ``params`` (e.g. a
    trained GPState) is threaded through every callable."""

    f: Callable      # (params, x_t, u, z) -> (rows, 1)
    g: Callable      # (params, x_t) -> (rows, 1)
    leaf: Optional[Callable]  # (params, x_t) -> (rows, 1) residual injection
    mu: float
    sigma: float
    T: float
    dim: int
    clip: float      # output clip (norm_estimation / uncertainty)
    center_z: bool = False
    # Full-history interior times: 'uniform' on [t, T], or 'sqrt' (tau = v^2,
    # importance weight 2 v), which cancels the 1/sqrt(tau) singularity of
    # the z weight.
    time_sampling: str = "uniform"
    terminal_z: str = "reference"   # 'reference': / (T - t); 'corrected': / sqrt(T - t)
    path_dtype: str = "float32"     # storage dtype of the Brownian paths
    terminal_crn: "bool | int" = False      # parity probe, not ported
    reference_semantics: bool = False       # parity probe, not ported
    # f at the level-0 (identically zero) estimate is bitwise zero (true for
    # the ScaSML residual generator), so the builders skip that f sweep.
    f_zero_at_zero: bool = False


def _z_accum(vals, weights, mf: int, centered: bool):
    """sum_i vals_i * weights_i over the MC axis, normalized by the effective
    sample count (unbiased covariance form when centered).
    vals: (B, mf); weights: (B, mf, dim)."""
    weights = weights.to(torch.float32)
    prod = torch.sum(vals[..., None] * weights, dim=1)
    if centered and mf > 1:
        corr = torch.sum(vals, dim=1)[:, None] * torch.sum(weights, dim=1) / mf
        return (prod - corr) / (mf - 1)
    return prod / mf


def _sample_var_of_mean(vals, mf: int):
    """Unbiased variance of mean(vals, axis=1); zero when mf < 2."""
    if mf < 2:
        return torch.zeros((vals.shape[0], 1), dtype=torch.float32,
                           device=vals.device)
    m = torch.mean(vals, dim=1, keepdim=True)
    s2 = torch.sum((vals - m) ** 2, dim=1, keepdim=True) / (mf - 1)
    return s2 / mf


def _terminal_pass(model: PicardModel, params, x, t, gen: torch.Generator,
                   mc: int, want_var: bool = False):
    """u = mean g(X_T), z = mean(g(X_T) xi) / (T - t + 1e-6), chunked over
    the MC axis; ``want_var`` also returns the variance of the u estimate."""
    B, dim, dev = x.shape[0], model.dim, x.device
    pd = DTYPES[model.path_dtype]
    dT = (model.T - t)[:, None]
    u_sum = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    usq_sum = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    z_sum = torch.zeros((B, dim), dtype=torch.float32, device=dev)
    xi_sum = torch.zeros((B, dim), dtype=torch.float32, device=dev)
    done = 0
    while done < mc:
        cur = min(_TERMINAL_MC_CHUNK, mc - done)
        xi = torch.randn((B, cur, dim), generator=gen, device=dev, dtype=pd)
        XT = (x[:, None, :] + model.mu * dT[..., None]
              + model.sigma * torch.sqrt(dT)[..., None] * xi)
        xt_T = torch.cat(
            [XT, torch.full((B, cur, 1), model.T, dtype=XT.dtype, device=dev)],
            dim=2,
        ).reshape(-1, dim + 1).to(torch.float32)
        gv = model.g(params, xt_T).reshape(B, cur).to(torch.float32)
        u_sum = u_sum + torch.sum(gv, dim=1, keepdim=True)
        if want_var:
            usq_sum = usq_sum + torch.sum(gv * gv, dim=1, keepdim=True)
        z_sum = z_sum + torch.sum(gv[..., None] * xi.to(torch.float32), dim=1)
        xi_sum = xi_sum + torch.sum(xi.to(torch.float32), dim=1)
        done += cur
    u = u_sum / mc
    u_var = None
    if want_var:
        s2 = (usq_sum - mc * u * u) / max(mc - 1, 1)
        u_var = torch.clamp_min(s2, 0.0) / mc
    if model.terminal_z == "corrected":
        denom_t = torch.sqrt(dT) + 1e-6
    else:
        denom_t = dT + 1e-6
    if model.center_z and mc > 1:
        z = (z_sum - u_sum * xi_sum / mc) / ((mc - 1) * denom_t)
    else:
        z = z_sum / (mc * denom_t)
    if want_var:
        return u, z, u_var
    return u, z


def _reject_parity_probes(model: PicardModel) -> None:
    if model.terminal_crn is not False or model.reference_semantics:
        raise NotImplementedError(
            "terminal_crn and reference_semantics are parity probes that are "
            "not ported (ROADMAP Queue 1 I)"
        )


def build_quadrature_uz(model: PicardModel, n: int, rho: int,
                        tables: PicardTables,
                        want_variance: bool = False) -> Callable:
    """fn(x_t, gen, params) -> (B, 1+dim) [u, z] for the quadrature variant;
    ``want_variance`` appends the top-level u-estimate MC variance column."""
    _reject_parity_probes(model)
    Mf, Mg, Q, c, w = tables
    T, dim = model.T, model.dim
    pd = DTYPES[model.path_dtype]

    def uz(lvl: int, x_t, gen, params, want_var: bool = False):
        B, dev = x_t.shape[0], x_t.device
        if lvl <= 0:
            return torch.zeros((B, 1 + dim), dtype=torch.float32, device=dev)
        x = x_t[:, :-1].to(torch.float32)
        t = x_t[:, -1].to(torch.float32)

        term = _terminal_pass(model, params, x, t, gen, int(Mg[rho - 1, lvl]),
                              want_var=want_var)
        if want_var:
            u, z, var = term
        else:
            (u, z), var = term, None
        if var is None:
            var = torch.zeros((B, 1), dtype=torch.float32, device=dev)

        for l in range(lvl):
            q = int(Q[rho - 1, lvl - l - 1])
            mf = int(Mf[rho - 1, lvl - l - 1])
            nodes = torch.as_tensor(c[:q, q - 1], dtype=torch.float32, device=dev)
            weights = torch.as_tensor(w[:q, q - 1], dtype=torch.float32, device=dev)
            cloc = t[:, None] + (T - t)[:, None] * nodes[None, :] / T  # (B, q)
            wloc = (T - t)[:, None] * weights[None, :] / T             # (B, q)
            dts = torch.diff(torch.cat([t[:, None], cloc], dim=1), dim=1)

            X = x[:, None, :].expand(B, mf, dim).to(pd)
            W = torch.zeros((B, mf, dim), dtype=pd, device=dev)
            for k in range(q):
                dt_k, c_k, w_k = dts[:, k], cloc[:, k], wloc[:, k][:, None]
                samp = (torch.zeros((B, mf), dtype=torch.float32, device=dev)
                        if want_var else None)
                dW = torch.sqrt(dt_k)[:, None, None] * torch.randn(
                    (B, mf, dim), generator=gen, device=dev, dtype=torch.float32)
                W = (W.to(torch.float32) + dW).to(pd)
                X = (X.to(torch.float32) + model.mu * dt_k[:, None, None]
                     + model.sigma * dW).to(pd)
                xt_k = torch.cat(
                    [X.to(torch.float32), c_k[:, None, None].expand(B, mf, 1)],
                    dim=2,
                ).reshape(-1, dim + 1)
                denom_k = (c_k - t + 1e-6)[:, None]

                if l > 0 or not model.f_zero_at_zero:
                    sim_l = uz(l, xt_k, gen, params)
                    y = model.f(params, xt_k, sim_l[:, :1], sim_l[:, 1:]).reshape(B, mf)
                    u = u + w_k * torch.mean(y, dim=1, keepdim=True)
                    z = z + w_k * _z_accum(y, W, mf, model.center_z) / denom_k
                    if want_var:
                        samp = samp + y
                if l:
                    if l - 1 > 0 or not model.f_zero_at_zero:
                        sim_lm1 = uz(l - 1, xt_k, gen, params)
                        y2 = model.f(params, xt_k, sim_lm1[:, :1],
                                     sim_lm1[:, 1:]).reshape(B, mf)
                        u = u - w_k * torch.mean(y2, dim=1, keepdim=True)
                        z = z - w_k * _z_accum(y2, W, mf, model.center_z) / denom_k
                        if want_var:
                            samp = samp - y2
                elif model.leaf is not None:
                    # GP PDE-residual injection at the leaf level
                    eps = model.leaf(params, xt_k).reshape(B, mf)
                    u = u + w_k * torch.mean(eps, dim=1, keepdim=True)
                    z = z + w_k * _z_accum(eps, W, mf, model.center_z) / denom_k
                    if want_var:
                        samp = samp + eps
                if want_var:
                    var = var + w_k**2 * _sample_var_of_mean(samp, mf)

        out = torch.clamp(torch.cat([u, z], dim=1), -model.clip, model.clip)
        if want_var:
            out = torch.cat([out, var], dim=1)  # variance column unclipped
        return out

    def fn(x_t, gen, params):
        return uz(n, x_t, gen, params, want_var=want_variance)

    return fn


def build_full_history_uz(model: PicardModel, n: int, M: int,
                          want_variance: bool = False) -> Callable:
    """fn(x_t, gen, params) -> (B, 1+dim) [u, z] for the full-history
    variant: level l samples M^(lvl-l) interior times tau on [t, T] and
    updates u += (T-t) mean(y w), z += (T-t) mean(y xi w / sqrt(tau + 1e-6)),
    where w is the time-sampling weight.  The terminal pass draws M^lvl
    samples.  ``want_variance`` appends the top-level u-estimate MC variance
    column (terminal pass plus each level's variance of the mean)."""
    _reject_parity_probes(model)
    T, dim = model.T, model.dim
    pd = DTYPES[model.path_dtype]

    def uz(lvl: int, x_t, gen, params, want_var: bool = False):
        B, dev = x_t.shape[0], x_t.device
        if lvl <= 0:
            return torch.zeros((B, 1 + dim), dtype=torch.float32, device=dev)
        x = x_t[:, :-1].to(torch.float32)
        t = x_t[:, -1].to(torch.float32)
        dT = (T - t)[:, None]

        term = _terminal_pass(model, params, x, t, gen, int(M**lvl),
                              want_var=want_var)
        if want_var:
            u, z, var = term
        else:
            (u, z), var = term, None

        for l in range(lvl):
            mf = int(M ** (lvl - l))
            v = torch.rand((B, mf), generator=gen, device=dev, dtype=torch.float32)
            if model.time_sampling == "sqrt":
                tau = v * v
                wgt = (2.0 * v)[..., None]
            else:
                tau = v
                wgt = torch.ones((B, mf, 1), dtype=torch.float32, device=dev)
            ts = (tau * dT)[..., None]                       # (B, mf, 1)
            xi = torch.randn((B, mf, dim), generator=gen, device=dev, dtype=pd)
            X = x[:, None, :] + model.mu * ts + model.sigma * torch.sqrt(ts) * xi
            xt_k = torch.cat([X, t[:, None, None] + ts], dim=2).reshape(
                -1, dim + 1).to(torch.float32)
            inv_sqrt = 1.0 / torch.sqrt(ts + 1e-6)
            eta = xi * inv_sqrt * wgt                        # (B, mf, dim)
            wflat = wgt[..., 0]
            samp = (torch.zeros((B, mf), dtype=torch.float32, device=dev)
                    if want_var else None)
            if l > 0 or not model.f_zero_at_zero:
                sim_l = uz(l, xt_k, gen, params)
                y = model.f(params, xt_k, sim_l[:, :1], sim_l[:, 1:]).reshape(B, mf)
                u = u + dT * torch.mean(y * wflat, dim=1, keepdim=True)
                z = z + dT * _z_accum(y, eta, mf, model.center_z)
                if want_var:
                    samp = samp + y * wflat
            if l:
                if l - 1 > 0 or not model.f_zero_at_zero:
                    sim_lm1 = uz(l - 1, xt_k, gen, params)
                    y2 = model.f(params, xt_k, sim_lm1[:, :1],
                                 sim_lm1[:, 1:]).reshape(B, mf)
                    u = u - dT * torch.mean(y2 * wflat, dim=1, keepdim=True)
                    z = z - dT * _z_accum(y2, eta, mf, model.center_z)
                    if want_var:
                        samp = samp - y2 * wflat
            elif model.leaf is not None:
                eps = model.leaf(params, xt_k).reshape(B, mf)
                u = u + dT * torch.mean(eps * wflat, dim=1, keepdim=True)
                z = z + dT * _z_accum(eps, eta, mf, model.center_z)
                if want_var:
                    samp = samp + eps * wflat
            if want_var:
                # levels draw independent samples, so their variances add
                var = var + dT * dT * _sample_var_of_mean(samp, mf)

        out = torch.clamp(torch.cat([u, z], dim=1), -model.clip, model.clip)
        if want_var:
            out = torch.cat([out, var], dim=1)  # variance column unclipped
        return out

    def fn(x_t, gen, params):
        return uz(n, x_t, gen, params, want_var=want_variance)

    return fn
