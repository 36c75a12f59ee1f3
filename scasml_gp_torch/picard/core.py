"""Multilevel Picard recursion over static schedules.

Port of ``scasml_gp_tpu/picard/core.py``: the quadrature variant, over the
(n, rho) tables of :mod:`scasml_gp_torch.picard.schedule`, and the
full-history variant, over sample counts M^k.  The recursion runs eagerly in
Python, and the quadrature-point scan is a Python loop.  Every draw comes
from the ``torch.Generator`` the caller passes in, taken in sequence: each
tree node gets fresh numbers and no seed is reused across nodes.  Results
match the JAX package in distribution, not bit for bit.

The caller may pass a :class:`ShardedDraws` instead of a generator: the
rollout then computes one rank's block of a batch split over a mesh's
'data' axis, and every draw is made for the whole batch, of which the rank
keeps its rows.  The ranks' generators stay in step, and their blocks
together are the unsplit rollout's numbers.

Two parity probes reproduce the reference's estimator quirks:
``terminal_crn`` reseeds every terminal pass (common random numbers across
the tree, the reference's PRNGKey(0) at every node), and
``reference_semantics`` (quadrature variant) draws the interior normals in
the path dtype, carries the z denominator delta_t as the reference does and
quantizes every level's output through float16.  torch cannot replay JAX's
threefry draws, so both match the JAX package in distribution, and their
control flow exactly.

On a CUDA device the solvers replay each schedule's rollout as a captured
CUDA graph (picard/graphs.py).  Whatever a rollout reads from the host (the
quadrature rules, the low-precision normals' constants) is therefore made on
the device on its first, eager call and kept.
"""

from __future__ import annotations

import functools
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
    # Parity probe: True reseeds every terminal pass with 0 (all passes of
    # one shape see the same draws, the reference's PRNGKey(0) at every
    # node); an int reseeds with that int; False draws from the stream.
    terminal_crn: "bool | int" = False
    # Parity probe of the quadrature variant: interior normals drawn in
    # path_dtype, the carried z denominator delta_t, float16 level outputs.
    reference_semantics: bool = False
    # f at the level-0 (identically zero) estimate is bitwise zero (true for
    # the ScaSML residual generator), so the builders skip that f sweep.
    f_zero_at_zero: bool = False


class ShardedDraws(NamedTuple):
    """A generator shared by the ``count`` ranks of a 'data' axis, of which
    this rank computes block ``index`` of every batch."""

    gen: torch.Generator
    index: int
    count: int


# Mantissa bits of the low-precision path dtypes, which set how many values
# a normal draw in them can take (below).
_MANTISSA = {torch.float16: 10, torch.bfloat16: 7}


@functools.lru_cache(maxsize=None)
def _lowp_constants(dtype: torch.dtype, device: torch.device):
    """(lo, span, sqrt 2) of ``_lowp_normal`` in ``dtype`` on ``device``,
    made once: a captured rollout (picard/graphs.py) may copy nothing from
    the host, so the first, eager call of a schedule makes them."""
    lo = torch.nextafter(torch.tensor(-1.0, dtype=dtype), torch.tensor(0.0, dtype=dtype))
    span = torch.tensor(1.0, dtype=dtype) - lo  # rounds to 2 in the dtype, as in JAX
    sqrt2 = torch.tensor(2.0 ** 0.5, dtype=dtype)
    return lo.to(device), span.to(device), sqrt2.to(device)


def _lowp_normal(shape, generator=None, device=None, dtype=torch.float16):
    """Standard normals in float16 or bfloat16 with the law of
    ``jax.random.normal`` in that dtype: sqrt(2) erfinv(u), with u uniform on
    the dtype's 2^mantissa levels in [nextafter(-1, 0), 1), computed in the
    dtype.  That law has 1024 values in float16 and 128 in bfloat16, no tail
    past 3.5 and 2.9, and a mean of -0.0015 and -0.011; torch's own
    ``randn`` in these dtypes rounds a float32 normal, another law, which
    moves the low-precision rollouts' estimates away from the JAX
    package's."""
    levels = 2 ** _MANTISSA[dtype]
    m = torch.randint(0, levels, tuple(shape), generator=generator, device=device)
    lo, span, sqrt2 = _lowp_constants(dtype, m.device)
    u = (m.to(torch.float32) / levels).to(dtype) * span + lo
    u = torch.maximum(u, lo)
    return torch.erfinv(u.to(torch.float32)).to(dtype) * sqrt2


def _draw(sample, gen, shape, **kw) -> torch.Tensor:
    """``sample(shape, generator=...)``; normals in a low-precision dtype
    follow JAX's law (``_lowp_normal``); for ShardedDraws, drawn for the
    whole batch (``count`` times the rows) and cut to this rank's block."""
    if sample is torch.randn and kw.get("dtype") in _MANTISSA:
        sample = _lowp_normal
    if not isinstance(gen, ShardedDraws):
        return sample(shape, generator=gen, **kw)
    B = shape[0]
    full = sample((B * gen.count,) + tuple(shape[1:]), generator=gen.gen, **kw)
    return full[gen.index * B:(gen.index + 1) * B]


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
    if model.terminal_crn is not False:
        # frozen per shape: True is the reference's seed 0, an int another.
        # A generator made inside the rollout cannot be registered with a
        # captured graph, so solvers with this probe run eagerly
        # (picard/graphs.py).
        seed = 0 if model.terminal_crn is True else int(model.terminal_crn)
        frozen = torch.Generator(device=dev).manual_seed(seed)
        gen = gen._replace(gen=frozen) if isinstance(gen, ShardedDraws) else frozen
    dT = (model.T - t)[:, None]
    u_sum = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    usq_sum = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    z_sum = torch.zeros((B, dim), dtype=torch.float32, device=dev)
    xi_sum = torch.zeros((B, dim), dtype=torch.float32, device=dev)
    done = 0
    while done < mc:
        cur = min(_TERMINAL_MC_CHUNK, mc - done)
        xi = _draw(torch.randn, gen, (B, cur, dim), device=dev, dtype=pd)
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


def build_quadrature_uz(model: PicardModel, n: int, rho: int,
                        tables: PicardTables,
                        want_variance: bool = False) -> Callable:
    """fn(x_t, gen, params) -> (B, 1+dim) [u, z] for the quadrature variant;
    ``want_variance`` appends the top-level u-estimate MC variance column."""
    Mf, Mg, Q, c, w = tables
    T, dim = model.T, model.dim
    pd = DTYPES[model.path_dtype]
    quad = {}  # (q, device) -> the q-point rule's nodes and weights there

    def rule(q: int, dev):
        # made on the first, eager call: a captured rollout copies nothing
        # from the host (picard/graphs.py)
        if (q, dev) not in quad:
            quad[q, dev] = tuple(torch.as_tensor(a[:q, q - 1], dtype=torch.float32,
                                                 device=dev) for a in (c, w))
        return quad[q, dev]

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
            nodes, weights = rule(q, dev)
            cloc = t[:, None] + (T - t)[:, None] * nodes[None, :] / T  # (B, q)
            wloc = (T - t)[:, None] * weights[None, :] / T             # (B, q)
            dts = torch.diff(torch.cat([t[:, None], cloc], dim=1), dim=1)

            X = x[:, None, :].expand(B, mf, dim).to(pd)
            W = torch.zeros((B, mf, dim), dtype=pd, device=dev)
            draw_dtype = pd if model.reference_semantics else torch.float32
            dt_ref = (T - t + 1e-6)[:, None]  # the terminal pass's delta_t
            for k in range(q):
                dt_k, c_k, w_k = dts[:, k], cloc[:, k], wloc[:, k][:, None]
                samp = (torch.zeros((B, mf), dtype=torch.float32, device=dev)
                        if want_var else None)
                dW = torch.sqrt(dt_k)[:, None, None] * _draw(
                    torch.randn, gen, (B, mf, dim), device=dev,
                    dtype=draw_dtype).to(torch.float32)
                W = (W.to(torch.float32) + dW).to(pd)
                X = (X.to(torch.float32) + model.mu * dt_k[:, None, None]
                     + model.sigma * dW).to(pd)
                xt_k = torch.cat(
                    [X.to(torch.float32), c_k[:, None, None].expand(B, mf, 1)],
                    dim=2,
                ).reshape(-1, dim + 1)
                denom_k = (c_k - t + 1e-6)[:, None]
                # the reference's carried delta_t: positive terms divide by
                # the value last assigned, (T - t) until an `if l:` body runs
                denom_pos = dt_ref if model.reference_semantics else denom_k

                if l > 0 or not model.f_zero_at_zero:
                    sim_l = uz(l, xt_k, gen, params)
                    y = model.f(params, xt_k, sim_l[:, :1], sim_l[:, 1:]).reshape(B, mf)
                    u = u + w_k * torch.mean(y, dim=1, keepdim=True)
                    z = z + w_k * _z_accum(y, W, mf, model.center_z) / denom_pos
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
                    dt_ref = denom_k  # the reference reassigns it here only
                elif model.leaf is not None:
                    # GP PDE-residual injection at the leaf level
                    eps = model.leaf(params, xt_k).reshape(B, mf)
                    u = u + w_k * torch.mean(eps, dim=1, keepdim=True)
                    z = z + w_k * _z_accum(eps, W, mf, model.center_z) / denom_pos
                    if want_var:
                        samp = samp + eps
                if want_var:
                    var = var + w_k**2 * _sample_var_of_mean(samp, mf)

        out = torch.clamp(torch.cat([u, z], dim=1), -model.clip, model.clip)
        if model.reference_semantics:
            # the reference quantizes every level's output; the carried
            # delta_t restarts at (T - t) per level, exact for n <= 2
            out = out.to(torch.float16).to(torch.float32)
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
            v = _draw(torch.rand, gen, (B, mf), device=dev, dtype=torch.float32)
            if model.time_sampling == "sqrt":
                tau = v * v
                wgt = (2.0 * v)[..., None]
            else:
                tau = v
                wgt = torch.ones((B, mf, 1), dtype=torch.float32, device=dev)
            ts = (tau * dT)[..., None]                       # (B, mf, 1)
            xi = _draw(torch.randn, gen, (B, mf, dim), device=dev, dtype=pd)
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
