"""Wrapper of the hand-written CUDA fused-posterior kernel
(``scasml_gp_torch/csrc/fused_posterior.cu``).

The kernel replaces the Pallas TPU kernel ``scripts/pallas_posterior.py``.
It folds the boundary set into the interior set: boundary row j contributes
what an interior row with weights (r1, r3, r4, r5) = (r2_j, 0, 0, 0) would, so
``prepare_inputs`` stacks both sets and their weights once per trained state
and one call computes the whole ``PosteriorOut``.  ``prepare_inputs`` also
computes each training row's |y|^2, spatial sum and time once, for the norm
form of the pair statistics (``gp.kernels.pair_stats``), and lays the rows out
for the kernel's tiles as columns: y feature-major, then the weights and the
row stats, padded with zero columns to a multiple of the tile ``BJ``.

``plan`` chooses the launch: blocks of ``BI`` evaluation rows, and where
those alone cannot fill the card, the training tiles split over ``S`` blocks
per row block.  With ``S > 1`` each block writes its share of the outputs to
a slice of scratch and a second small kernel adds the slices in split order,
so the profiler shows two device kernels for such a call; ``launches`` still
counts one per call.

``prepare_inputs(..., operand_dtype=torch.bfloat16)`` prepares the inputs of
the bf16-operand variant (the JAX package's ``operand_dtype='bfloat16'``):
the same columns, with the row stats of the bf16-rounded y, and
``rows_bf16``, the training rows rounded to bf16 once, row-major with the
width padded to a multiple of 16: the operand of the kernel's tensor-core
x.y product.  The kernel rounds x itself, and keeps x and y unrounded for
the gradient's contractions.

``fused_posterior`` launches the kernel for CUDA tensors and counts the
launch in ``launches`` (a captured rollout's launches are counted on each
replay: picard/graphs.py).  For CPU tensors it runs ``stacked_posterior``, the
same stacked computation in plain PyTorch.  There is no fallback between the
two: a CUDA tensor launches the kernel or raises.  Under the debug NaN
checks (utils/debug.py), which cannot see inside the kernel, it checks its
own outputs.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import _disable_current_modes

from scasml_gp_torch.gp.kernels import pair_stats, row_stats, split_gamma
from scasml_gp_torch.gp.posterior import PosteriorOut, _split_r
from scasml_gp_torch.utils import build, debug

# Kernel launches made by fused_posterior, in total and by (want_grad,
# want_ops) specialisation of the float32 and of the bf16-operand variant;
# reset with reset_launches.
launches = 0
launches_by_flags = {}
bf16_launches_by_flags = {}

# The kernel's tiling (csrc/fused_posterior.cu): BI evaluation rows per
# block of 256 threads, BJ training rows per tile, two tile stages.
BI = BJ = 64
MAX_FEATURES = 256
RECORD = 7                 # record rows of ``cols`` after the F rows of y
SMEM_PER_BLOCK = 232448    # H100: the most a block may opt in to


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_flags.clear()
    bf16_launches_by_flags.clear()


def launch_counts() -> tuple:
    """A copy of the counters: (launches, by flags, bf16 by flags)."""
    return launches, dict(launches_by_flags), dict(bf16_launches_by_flags)


def take_launches_since(before: tuple) -> tuple:
    """Put the counters back to ``before`` (a ``launch_counts``) and return
    what was counted since, in the same form.  A CUDA-graph capture runs the
    wrapper without launching the kernel; picard/graphs.py takes its counts
    back here and adds them with ``add_launches`` on every replay."""
    global launches
    total, by_flags, bf16_by_flags = launch_counts()
    delta = (total - before[0],
             {k: v - before[1].get(k, 0) for k, v in by_flags.items()
              if v != before[1].get(k, 0)},
             {k: v - before[2].get(k, 0) for k, v in bf16_by_flags.items()
              if v != before[2].get(k, 0)})
    launches = before[0]
    for counts, old in ((launches_by_flags, before[1]), (bf16_launches_by_flags, before[2])):
        counts.clear()
        counts.update(old)
    return delta


def add_launches(delta: tuple) -> None:
    """Count the launches ``delta`` (a ``take_launches_since``) once more."""
    global launches
    launches += delta[0]
    for counts, extra in ((launches_by_flags, delta[1]), (bf16_launches_by_flags, delta[2])):
        for k, v in extra.items():
            counts[k] = counts.get(k, 0) + v


class FusedInputs(NamedTuple):
    """Kernel inputs, prepared once per trained state."""

    y: torch.Tensor        # (m, d+1) interior rows, then boundary rows
    r: torch.Tensor        # (m, 4) [r1, r3, r4, r5]; boundary rows [r2, 0, 0, 0]
    y_stats: torch.Tensor  # (m, 3) |y|^2, spatial sum, time of each row
    cols: torch.Tensor     # (d+1+7, m_pad) [y^T; r^T; y_stats^T], zero past m
    gamma: tuple           # (gs, gt, gr) as Python floats
    dim: int
    operand_dtype: torch.dtype = torch.float32  # of the pair statistics
    # bf16 only: (m_pad, Fp) y rounded to bf16, zero past m and past F
    rows_bf16: Optional[torch.Tensor] = None


OPERAND_DTYPES = {None: torch.float32, "float32": torch.float32,
                  torch.float32: torch.float32, "bfloat16": torch.bfloat16,
                  torch.bfloat16: torch.bfloat16}


def operand_dtype_of(operand_dtype) -> torch.dtype:
    """torch dtype of a posterior ``operand_dtype`` (PrecisionPolicy.gram):
    float32 or bfloat16; anything else raises."""
    try:
        return OPERAND_DTYPES[operand_dtype]
    except (KeyError, TypeError):
        raise ValueError(f"unknown posterior operand dtype {operand_dtype!r}; "
                         "use 'float32' or 'bfloat16'") from None


def prepare_inputs(x_dom, x_bdy, r, gamma, dim: int,
                   operand_dtype=torch.float32) -> FusedInputs:
    """The kernel's inputs for a trained state; with ``operand_dtype``
    bfloat16 the row stats are those of the bf16-rounded rows."""
    od = operand_dtype_of(operand_dtype)
    n_dom, n_bdy = x_dom.shape[0], x_bdy.shape[0]
    r1, r2, r3, r4, r5 = _split_r(r.to(torch.float32), n_dom, n_bdy)
    r_dom = torch.stack([r1, r3, r4, r5], dim=1)
    r_bdy = torch.zeros((n_bdy, 4), dtype=torch.float32, device=r.device)
    r_bdy[:, 0] = r2
    y = torch.cat([x_dom, x_bdy], dim=0).to(torch.float32).contiguous()
    w = torch.cat([r_dom, r_bdy], dim=0).contiguous()
    stats = row_stats(y.to(od).to(torch.float32))
    m, F = y.shape
    cols = y.new_zeros((F + RECORD, _cdiv(m, BJ) * BJ))
    cols[:, :m] = torch.cat([y, w, stats], dim=1).T
    return FusedInputs(y=y, r=w, y_stats=stats, cols=cols,
                       gamma=tuple(float(g) for g in split_gamma(gamma)),
                       dim=int(dim), operand_dtype=od,
                       rows_bf16=_rows_bf16(y) if od == torch.bfloat16 else None)


def padded_depth(F: int) -> int:
    """The bf16 variant's x.y depth: F padded with zeros to a multiple of
    the tensor-core product's k-step, 16."""
    return _cdiv(F, 16) * 16


def _rows_bf16(y):
    """y (m, F) rounded to bf16, as the (m_pad, Fp) row-major operand tile
    of the bf16 variant: zero past m and past F."""
    m, F = y.shape
    rows = y.new_zeros((_cdiv(m, BJ) * BJ, padded_depth(F)), dtype=torch.bfloat16)
    rows[:m, :F] = y.to(torch.bfloat16)
    return rows


def shard_inputs(fused: FusedInputs, lo: int, hi: int) -> FusedInputs:
    """The inputs of the stacked training rows [lo, hi) alone: a 'model'
    rank's slice (parallel/mesh.py).  Boundary rows keep their (r2, 0, 0, 0)
    weights wherever the slice falls."""
    if not 0 <= lo < hi <= fused.y.shape[0]:
        raise ValueError(f"shard_inputs: rows [{lo}, {hi}) of {fused.y.shape[0]}")
    y, w, stats = fused.y[lo:hi], fused.r[lo:hi], fused.y_stats[lo:hi]
    cols = y.new_zeros((y.shape[1] + RECORD, _cdiv(hi - lo, BJ) * BJ))
    cols[:, :hi - lo] = torch.cat([y, w, stats], dim=1).T
    rows = None if fused.rows_bf16 is None else _rows_bf16(y)
    return fused._replace(y=y, r=w, y_stats=stats, cols=cols, rows_bf16=rows)


def stacked_posterior(x, fused: FusedInputs, want_grad: bool,
                      want_ops: bool) -> PosteriorOut:
    """The kernel's computation in plain PyTorch: one stacked training set
    with its precomputed row stats, one weight polynomial per output."""
    gs, gt, gr = fused.gamma
    d = fused.dim
    G = gs + d * gr
    beta = 2.0 * gs * gr + d * gr * gr
    y = fused.y
    r1, r3, r4, r5 = (fused.r[:, i][None, :] for i in range(4))
    st = pair_stats(x, y, fused.gamma, fused.operand_dtype, y_stats=fused.y_stats)
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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Plan(NamedTuple):
    """One call's launch: a grid of (row_blocks, splits) blocks of BI rows,
    each walking its share of the training tiles of BJ rows."""

    row_blocks: int
    tiles: int
    splits: int                 # S
    smem_bytes: int             # dynamic shared memory of one block
    blocks_per_sm: int
    scratch_shape: Optional[Tuple[int, int]]  # (S, n * out_width) when S > 1


def smem_bytes(F: int, want_grad: bool, bf16: bool = False) -> int:
    """Shared memory of one block, as fused_posterior.cu lays it out (the
    launcher takes its own count from there).  float32: the x tile and its
    stats, two stages of y tile and records, and the A_sp tile with the
    gradient.  bf16: the x stats, two stages of records (after the float32
    y tile with the gradient), the A_sp tile with the gradient, then bf16
    tiles of 64 rows of padded_depth(F) + 8 values: x, and y (one with the
    gradient, two without)."""
    if bf16:
        floats = (3 * BI + 2 * ((F if want_grad else 0) + RECORD) * (BJ + 4)
                  + (BI * (BJ + 4) if want_grad else 0))
        return 4 * floats + 2 * (BI + (1 if want_grad else 2) * BJ) * (padded_depth(F) + 8)
    floats = (F * (BI + 4) + 3 * BI + 2 * (F + RECORD) * (BJ + 4)
              + (BI * (BJ + 4) if want_grad else 0))
    return 4 * floats


def out_width(F: int, want_grad: bool, want_ops: bool) -> int:
    """Outputs per evaluation row: u, the F gradient columns, dt, div, lap.
    The kernel writes them as [u (n) | grad (n, F) | dt, div, lap (n each)],
    and each split of a call writes one such slice of scratch."""
    return 1 + (F if want_grad else 0) + (3 if want_ops else 0)


def plan(n: int, m: int, F: int, sm_count: int, blocks_per_sm: int,
         want_grad: bool = True, want_ops: bool = False, bf16: bool = False) -> Plan:
    """The launch for n evaluation rows against m training rows of width F
    on a card with ``sm_count`` SMs, each holding ``blocks_per_sm`` blocks of
    the kernel at once (the wrapper asks the CUDA runtime).

    S minimises a wave model of the call's time, ties to the fewest splits:
    the grid runs in ceil(row_blocks * S / slots) waves of the card's
    resident block slots, and a block costs its ceil(tiles / S) training
    tiles plus about one tile of prologue (the x tile, the first copy) and
    epilogue.  Against a sweep of S at the main path's ten shapes on an H100
    (``python -m scasml_gp_torch.measure``), it picks the measured best S or
    one within 7% of it; filling every slot (the smallest S with
    row_blocks * S >= slots) cost 11-30% there.  ``bf16`` plans the
    bf16-operand variant, whose blocks lay out their shared memory
    differently (``smem_bytes``)."""
    if not 2 <= F <= MAX_FEATURES:
        raise ValueError(f"fused_posterior supports 2 <= d + 1 <= {MAX_FEATURES}, got {F}")
    if m < 1 or n < 0 or sm_count < 1 or blocks_per_sm < 1:
        raise ValueError(f"plan: bad sizes n={n}, m={m}, sm_count={sm_count}, "
                         f"blocks_per_sm={blocks_per_sm}")
    smem = smem_bytes(F, want_grad, bf16)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"plan: {smem} bytes of shared memory exceed {SMEM_PER_BLOCK}")
    row_blocks = _cdiv(n, BI)
    tiles = _cdiv(m, BJ)
    slots = sm_count * blocks_per_sm

    def waves_times_work(S):
        return _cdiv(row_blocks * S, slots) * (_cdiv(tiles, S) + 1)

    splits = (min(range(1, tiles + 1), key=lambda S: (waves_times_work(S), S))
              if row_blocks else 1)
    scratch = (splits, n * out_width(F, want_grad, want_ops)) if splits > 1 else None
    return Plan(row_blocks=row_blocks, tiles=tiles, splits=splits, smem_bytes=smem,
                blocks_per_sm=blocks_per_sm, scratch_shape=scratch)


def _check(name, t, device, shape, dtype=torch.float32):
    if t is None:
        raise ValueError(f"{name} is missing")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.shape != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _occupancy(index: int, want_grad: bool, want_ops: bool, bf16: bool, F: int) -> int:
    import ctypes

    lib = build.load_library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = lib.scasml_fused_posterior_occupancy(int(want_grad), int(want_ops), int(bf16),
                                                  F, ctypes.byref(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(
            "fused_posterior: the kernel fits no block on an SM: "
            f"{lib.scasml_cuda_error_string(rc).decode()} ({rc}), "
            f"{blocks.value} blocks")
    return blocks.value


@functools.lru_cache(maxsize=256)
def _card_plan(index: int, n: int, m: int, F: int, want_grad: bool,
               want_ops: bool, bf16: bool) -> Plan:
    return plan(n, m, F, _sm_count(index),
                _occupancy(index, want_grad, want_ops, bf16, F), want_grad, want_ops, bf16)


def launch_plan(x, fused: FusedInputs, want_grad: bool, want_ops: bool) -> Plan:
    """The plan fused_posterior launches for x on its card."""
    return _card_plan(x.device.index, x.shape[0], fused.y.shape[0], fused.dim + 1,
                      bool(want_grad), bool(want_ops),
                      fused.operand_dtype == torch.bfloat16)


def fused_posterior(x, fused: FusedInputs, want_grad: bool = False,
                    want_ops: bool = False) -> PosteriorOut:
    """PosteriorOut at x (n, d+1): the CUDA kernel for a CUDA tensor, the
    plain ``stacked_posterior`` for a CPU tensor."""
    if x.device.type == "cpu":
        return stacked_posterior(x.to(torch.float32), fused, want_grad, want_ops)
    if not x.is_cuda:
        raise ValueError(f"fused_posterior: unsupported device {x.device}")
    if debug.active():
        # The NaN checks cannot see inside the kernel: launch it with them
        # off, then check its outputs here.
        with _disable_current_modes():
            out = fused_posterior(x, fused, want_grad, want_ops)
            debug.check("fused_posterior (CUDA kernel)", out)
        return out
    # Every line below runs on the host once per call, and the small calls
    # of a solve take longer on the host than on the device: keep it short.
    global launches
    lib = build.load_library()
    F = fused.dim + 1
    n, m_pad = x.shape[0], _cdiv(fused.y.shape[0], BJ) * BJ
    if F > MAX_FEATURES:
        raise ValueError(f"fused_posterior supports d + 1 <= {MAX_FEATURES}, got {F}")
    dev = x.device
    _check("x", x, dev, (n, F))
    _check("fused.cols", fused.cols, dev, (F + RECORD, m_pad))
    if fused.cols.data_ptr() % 16:
        raise ValueError("fused.cols must be 16-byte aligned")
    bf16 = fused.operand_dtype == torch.bfloat16
    if bf16:
        _check("fused.rows_bf16", fused.rows_bf16, dev, (m_pad, padded_depth(F)), torch.bfloat16)
        if fused.rows_bf16.data_ptr() % 16:
            raise ValueError("fused.rows_bf16 must be 16-byte aligned")
    # One allocation for every output, in the kernel's order: u, grad, then
    # dt, div, lap.
    sizes = [n] + ([n * F] if want_grad else []) + ([n] * 3 if want_ops else [])
    buf = torch.empty((sum(sizes),), dtype=torch.float32, device=dev)
    parts = list(buf.split(sizes))
    u = parts.pop(0)
    grad = parts.pop(0).view(n, F) if want_grad else None
    dt_u, div_u, lap_u = parts if want_ops else (None, None, None)
    out = PosteriorOut(u=u, grad=grad, dt_u=dt_u, div_u=div_u, lap_u=lap_u)
    if n == 0:
        return out
    p = launch_plan(x, fused, want_grad, want_ops)
    scratch = (torch.empty(p.scratch_shape, dtype=torch.float32, device=dev)
               if p.splits > 1 else None)
    rc = lib.scasml_fused_posterior(
        dev.index, int(want_grad), int(want_ops), int(bf16), x.data_ptr(),
        fused.cols.data_ptr(), fused.rows_bf16.data_ptr() if bf16 else None,
        n, m_pad, F, *fused.gamma, p.splits,
        None if scratch is None else scratch.data_ptr(), buf.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index),  # current_stream's, without a Stream
    )
    if rc != 0:
        raise RuntimeError(
            "fused_posterior launch failed: "
            f"{lib.scasml_cuda_error_string(rc).decode()} ({rc})"
        )
    launches += 1
    key = (bool(want_grad), bool(want_ops))
    counts = bf16_launches_by_flags if bf16 else launches_by_flags
    counts[key] = counts.get(key, 0) + 1
    return out
