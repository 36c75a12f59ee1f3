"""GP posterior evaluation: mean, gradient and PDE-operator features.

Port of ``scasml_gp_tpu/gp/posterior.py``.  Every output is a row sum of
kappa(x_i, y_j) times a polynomial in the pair statistics with the
representer weights folded in, plus two contractions against the training
points for the gradient.

``posterior_block`` is the plain PyTorch version.  ``posterior_eval`` runs it
for tensors on the CPU and the hand-written CUDA kernel of
:mod:`scasml_gp_torch.gp.fused_posterior` for tensors on a GPU; it never
falls back from one to the other.

``operand_dtype='bfloat16'`` (PrecisionPolicy.gram) computes the pair
statistics from bf16-rounded x and training rows, with float32 products and
sums, while the gradient's contractions keep the unrounded rows, as the JAX
package does.  ``shard_dom`` (a mesh, parallel/mesh.py) splits the training
rows over its 'model' axis: each rank evaluates its slice and the ranks add
the partial sums, which is exact because every output is a sum over
training rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from scasml_gp_torch.gp.kernels import pair_stats, split_gamma


class PosteriorOut(NamedTuple):
    u: torch.Tensor                # (n,)
    grad: Optional[torch.Tensor]   # (n, d+1) full space-time gradient, or None
    dt_u: Optional[torch.Tensor]   # (n,) time derivative, or None
    div_u: Optional[torch.Tensor]  # (n,) spatial divergence, or None
    lap_u: Optional[torch.Tensor]  # (n,) spatial Laplacian, or None


def _split_r(r: torch.Tensor, n_dom: int, n_bdy: int):
    """Split representer weights by phi block:
    [ID@dom, ID@bdy, LAP@dom, DT@dom, DIV@dom]."""
    r1 = r[:n_dom]
    r2 = r[n_dom: n_dom + n_bdy]
    r3 = r[n_dom + n_bdy: 2 * n_dom + n_bdy]
    r4 = r[2 * n_dom + n_bdy: 3 * n_dom + n_bdy]
    r5 = r[3 * n_dom + n_bdy:]
    return r1, r2, r3, r4, r5


def posterior_block(x, x_dom, x_bdy, r, gamma, dim: int, want_grad: bool,
                    want_ops: bool, operand_dtype=torch.float32) -> PosteriorOut:
    """Single-pass posterior for one block of evaluation points x (n, d+1),
    in plain PyTorch (the JAX ``_posterior_block``); ``operand_dtype``
    (float32 or bfloat16) is that of the pair statistics; float64 computes
    everything in float64, the reference the float32 versions are held to."""
    gs, gt, gr = split_gamma(gamma)
    d = dim
    G = gs + d * gr
    beta = 2.0 * gs * gr + d * gr * gr
    n_dom, n_bdy = x_dom.shape[0], x_bdy.shape[0]
    work = torch.float64 if operand_dtype == torch.float64 else torch.float32
    r1, r2, r3, r4, r5 = (
        v[None, :] for v in _split_r(r.to(work), n_dom, n_bdy)
    )
    x, x_dom, x_bdy = x.to(work), x_dom.to(work), x_bdy.to(work)

    st = pair_stats(x, x_dom, gamma, operand_dtype)
    stb = pair_stats(x, x_bdy, gamma, operand_dtype)
    k, q, s, dt = st.kappa, st.q, st.s, st.dt
    kb, sb, dtb = stb.kappa, stb.s, stb.dt
    lapf = gs * gs * q + beta * s * s - d * (gs + gr)

    P_u = r1 + lapf * r3 + gt * dt * r4 + G * s * r5
    u = torch.sum(k * P_u, dim=1) + kb @ r2[0]

    grad = None
    if want_grad:
        A_sp = -gs * k * P_u + 2.0 * gs * gs * k * r3
        B_s = -gr * k * P_u + 2.0 * beta * k * r3
        A_t = -gt * k * P_u
        C = G * k * r5
        E = gt * k * r4
        Ab_sp = -gs * kb * r2
        Bb_s = -gr * kb * r2
        Ab_t = -gt * kb * r2

        rs_sp = torch.sum(A_sp, dim=1) + torch.sum(Ab_sp, dim=1)
        AY_sp = A_sp @ x_dom[:, :-1] + Ab_sp @ x_bdy[:, :-1]
        c_row = (
            torch.sum(C, dim=1)
            + torch.sum(B_s * s, dim=1)
            + torch.sum(Bb_s * sb, dim=1)
        )
        grad_sp = x[:, :-1] * rs_sp[:, None] - AY_sp + c_row[:, None]
        rs_t = torch.sum(A_t, dim=1) + torch.sum(Ab_t, dim=1)
        aty = A_t @ x_dom[:, -1] + Ab_t @ x_bdy[:, -1]
        grad_t = x[:, -1] * rs_t - aty + torch.sum(E, dim=1)
        grad = torch.cat([grad_sp, grad_t[:, None]], dim=1)

    dt_u = div_u = lap_u = None
    if want_ops:
        P_dt = (
            -gt * dt * r1
            - gt * dt * lapf * r3
            + gt * (1.0 - gt * dt * dt) * r4
            - G * gt * s * dt * r5
        )
        dt_u = torch.sum(k * P_dt, dim=1) - gt * torch.sum(kb * dtb * r2, dim=1)

        P_div = (
            -G * s * r1
            + G * s * (2.0 * G - lapf) * r3
            - G * gt * s * dt * r4
            + G * (d - G * s * s) * r5
        )
        div_u = torch.sum(k * P_div, dim=1) - G * torch.sum(kb * sb * r2, dim=1)

        LL = (
            2.0 * d * (gs * gs + beta)
            - 4.0 * gs**3 * q
            - 4.0 * s * s * (gs * gs * gr + beta * G)
            + lapf * lapf
        )
        P_lap = (
            lapf * r1
            + LL * r3
            + gt * dt * lapf * r4
            - G * s * (2.0 * G - lapf) * r5
        )
        lapfb = gs * gs * stb.q + beta * sb * sb - d * (gs + gr)
        lap_u = torch.sum(k * P_lap, dim=1) + torch.sum(kb * lapfb * r2, dim=1)

    return PosteriorOut(u=u, grad=grad, dt_u=dt_u, div_u=div_u, lap_u=lap_u)


def posterior_eval(x, x_dom, x_bdy, r, gamma, dim: int,
                   want_grad: bool = False, want_ops: bool = False,
                   chunk: Optional[int] = None, operand_dtype=None,
                   shard_dom=None, fused=None) -> PosteriorOut:
    """Posterior over x (n, d+1).

    CPU tensors take the plain version, ``chunk`` rows at a time when
    ``n > chunk``.  CUDA tensors launch the fused kernel once; ``chunk`` is
    ignored there, and ``fused`` may carry the kernel's inputs prepared once
    per trained state (``GPState.fused_inputs``), for ``operand_dtype``.
    With a ``shard_dom`` mesh of more than one 'model' rank, ``fused`` is
    this rank's slice of them and the outputs are summed over the axis."""
    from scasml_gp_torch.gp import fused_posterior as fp
    from scasml_gp_torch.parallel.mesh import check_mesh

    od = fp.operand_dtype_of(operand_dtype)
    if shard_dom is not None and check_mesh(shard_dom).model > 1:
        return _sharded_posterior(x, x_dom, x_bdy, r, gamma, dim, want_grad,
                                  want_ops, chunk, od, shard_dom, fused)
    if x.is_cuda:
        if fused is None:
            fused = fp.prepare_inputs(x_dom, x_bdy, r, gamma, dim, od)
        return fp.fused_posterior(x, fused, want_grad, want_ops)
    return _chunked(lambda xc: posterior_block(
        xc, x_dom, x_bdy, r, gamma, dim, want_grad, want_ops, od), x, chunk)


def _chunked(block, x, chunk: Optional[int]) -> PosteriorOut:
    n = x.shape[0]
    if chunk is None or n <= chunk:
        return block(x)
    parts = [block(x[i: i + chunk]) for i in range(0, n, chunk)]
    return PosteriorOut(*(
        None if vals[0] is None else torch.cat(vals, dim=0)
        for vals in zip(*parts)
    ))


def _sharded_posterior(x, x_dom, x_bdy, r, gamma, dim, want_grad, want_ops,
                       chunk, od, mesh, fused) -> PosteriorOut:
    """This rank's share of the posterior, against its 'model' slice of the
    stacked training rows (the kernel on a CUDA tensor, its plain twin on a
    CPU one), summed over the 'model' axis in one collective."""
    from scasml_gp_torch.gp import fused_posterior as fp
    from scasml_gp_torch.parallel.mesh import all_reduce_sum, train_point_sharding

    if fused is None:
        full = fp.prepare_inputs(x_dom, x_bdy, r, gamma, dim, od)
        fused = fp.shard_inputs(full, *train_point_sharding(mesh, full.y.shape[0]))
    x = x.to(torch.float32)
    if x.is_cuda:
        part = fp.fused_posterior(x, fused, want_grad, want_ops)
    else:
        part = _chunked(lambda xc: fp.stacked_posterior(xc, fused, want_grad, want_ops),
                        x, chunk)
    present = [v for v in part if v is not None]
    flat = all_reduce_sum(torch.cat([v.reshape(-1) for v in present]), mesh.model_group)
    sums = iter(flat.split([v.numel() for v in present]))
    return PosteriorOut(*(None if v is None else next(sums).view(v.shape) for v in part))
