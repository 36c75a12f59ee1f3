"""Wrapper of the hand-written CUDA fused-posterior kernel
(``scasml_gp_torch/csrc/fused_posterior.cu``).

The kernel replaces the Pallas TPU kernel ``scripts/pallas_posterior.py``.
It folds the boundary set into the interior set: boundary row j contributes
what an interior row with weights (r1, r3, r4, r5) = (r2_j, 0, 0, 0) would, so
``prepare_inputs`` stacks both sets and their weights once per trained state
and one launch computes the whole ``PosteriorOut``.

``fused_posterior`` launches the kernel for CUDA tensors and counts the
launch in ``launches``.  For CPU tensors it runs ``stacked_posterior``, the
same stacked computation in plain PyTorch.  There is no fallback between the
two: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scasml_gp_torch.gp.kernels import pair_stats, split_gamma
from scasml_gp_torch.gp.posterior import PosteriorOut, _split_r

# Kernel launches made by fused_posterior, in total and by (want_grad,
# want_ops) specialisation; reset with reset_launches.
launches = 0
launches_by_flags = {}


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_flags.clear()


class FusedInputs(NamedTuple):
    """Kernel inputs, prepared once per trained state."""

    y: torch.Tensor   # (N + Nb, d+1) interior rows, then boundary rows
    r: torch.Tensor   # (N + Nb, 4) [r1, r3, r4, r5]; boundary rows [r2, 0, 0, 0]
    gamma: tuple      # (gs, gt, gr) as Python floats
    dim: int


def prepare_inputs(x_dom, x_bdy, r, gamma, dim: int) -> FusedInputs:
    n_dom, n_bdy = x_dom.shape[0], x_bdy.shape[0]
    r1, r2, r3, r4, r5 = _split_r(r.to(torch.float32), n_dom, n_bdy)
    r_dom = torch.stack([r1, r3, r4, r5], dim=1)
    r_bdy = torch.zeros((n_bdy, 4), dtype=torch.float32, device=r.device)
    r_bdy[:, 0] = r2
    y = torch.cat([x_dom, x_bdy], dim=0).to(torch.float32).contiguous()
    return FusedInputs(
        y=y,
        r=torch.cat([r_dom, r_bdy], dim=0).contiguous(),
        gamma=tuple(float(g) for g in split_gamma(gamma)),
        dim=int(dim),
    )


def stacked_posterior(x, fused: FusedInputs, want_grad: bool,
                      want_ops: bool) -> PosteriorOut:
    """The kernel's computation in plain PyTorch: one stacked training set,
    one weight polynomial per output."""
    gs, gt, gr = fused.gamma
    d = fused.dim
    G = gs + d * gr
    beta = 2.0 * gs * gr + d * gr * gr
    y = fused.y
    r1, r3, r4, r5 = (fused.r[:, i][None, :] for i in range(4))
    st = pair_stats(x, y, fused.gamma)
    k, q, s, dt = st.kappa, st.q, st.s, st.dt
    lapf = gs * gs * q + beta * s * s - d * (gs + gr)
    P_u = r1 + lapf * r3 + gt * dt * r4 + G * s * r5
    kPu = k * P_u
    u = kPu.sum(1)

    grad = None
    if want_grad:
        A_sp = -gs * kPu + 2.0 * gs * gs * k * r3
        B_s = -gr * kPu + 2.0 * beta * k * r3
        A_t = -gt * kPu
        c_row = (G * k * r5 + B_s * s).sum(1)
        grad_sp = x[:, :-1] * A_sp.sum(1)[:, None] - A_sp @ y[:, :-1] + c_row[:, None]
        grad_t = x[:, -1] * A_t.sum(1) - A_t @ y[:, -1] + (gt * k * r4).sum(1)
        grad = torch.cat([grad_sp, grad_t[:, None]], dim=1)

    dt_u = div_u = lap_u = None
    if want_ops:
        P_dt = (-gt * dt * r1 - gt * dt * lapf * r3
                + gt * (1.0 - gt * dt * dt) * r4 - G * gt * s * dt * r5)
        P_div = (-G * s * r1 + G * s * (2.0 * G - lapf) * r3
                 - G * gt * s * dt * r4 + G * (d - G * s * s) * r5)
        LL = (2.0 * d * (gs * gs + beta) - 4.0 * gs**3 * q
              - 4.0 * s * s * (gs * gs * gr + beta * G) + lapf * lapf)
        P_lap = (lapf * r1 + LL * r3 + gt * dt * lapf * r4
                 - G * s * (2.0 * G - lapf) * r5)
        dt_u = (k * P_dt).sum(1)
        div_u = (k * P_div).sum(1)
        lap_u = (k * P_lap).sum(1)
    return PosteriorOut(u=u, grad=grad, dt_u=dt_u, div_u=div_u, lap_u=lap_u)


def _check(name, t, device, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


def fused_posterior(x, fused: FusedInputs, want_grad: bool = False,
                    want_ops: bool = False) -> PosteriorOut:
    """PosteriorOut at x (n, d+1): the CUDA kernel for a CUDA tensor, the
    plain ``stacked_posterior`` for a CPU tensor."""
    if x.device.type == "cpu":
        return stacked_posterior(x.to(torch.float32), fused, want_grad, want_ops)
    if not x.is_cuda:
        raise ValueError(f"fused_posterior: unsupported device {x.device}")
    from scasml_gp_torch.utils.build import load_library

    global launches
    lib = load_library()
    F = fused.dim + 1
    n, m = x.shape[0], fused.y.shape[0]
    if F > lib.scasml_fused_posterior_max_features():
        raise ValueError(
            f"fused_posterior supports d + 1 <= "
            f"{lib.scasml_fused_posterior_max_features()}, got {F}"
        )
    dev = x.device
    _check("x", x, dev, (n, F))
    _check("fused.y", fused.y, dev, (m, F))
    _check("fused.r", fused.r, dev, (m, 4))
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    grad = torch.empty((n, F), dtype=torch.float32, device=dev) if want_grad else None
    ops = [torch.empty((n,), dtype=torch.float32, device=dev) if want_ops else None
           for _ in range(3)]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.scasml_fused_posterior(
            int(want_grad), int(want_ops), x.data_ptr(), fused.y.data_ptr(),
            fused.r.data_ptr(), n, m, F, *fused.gamma,
            u.data_ptr(), ptr(grad), ptr(ops[0]), ptr(ops[1]), ptr(ops[2]),
            stream,
        )
    if rc != 0:
        raise RuntimeError(
            "fused_posterior launch failed: "
            f"{lib.scasml_cuda_error_string(rc).decode()} ({rc})"
        )
    if n:
        launches += 1
        key = (bool(want_grad), bool(want_ops))
        launches_by_flags[key] = launches_by_flags.get(key, 0) + 1
    return PosteriorOut(u=u, grad=grad, dt_u=ops[0], div_u=ops[1], lap_u=ops[2])
