"""The fused-posterior kernel's launch plan and input layout, on the CPU.

``plan`` (scasml_gp_torch/gp/fused_posterior.py) is the pure function that
tiles a call for the CUDA kernel: blocks of 64 evaluation rows, the training
tiles split over S blocks where the rows alone cannot fill the card.  These
tests hold what the kernel relies on (every evaluation row and every
training tile covered exactly once, shared memory within the H100's 227 KB,
the scratch shape) and the split choices measured on the card.
"""

import numpy as np
import pytest
import torch

from scasml_gp_torch.gp import fused_posterior as fp
from scasml_gp_torch.gp.kernels import kernel_gammas

torch.set_num_threads(2)

SMS = 132  # H100 SXM
ROWS = (0, 1, 1337, 204800)
WIDTHS = (2, 21, 101, 256)
TRAIN = (1, 200, 1200, 1337)


@pytest.mark.parametrize("want_grad", [False, True])
@pytest.mark.parametrize("F", WIDTHS)
@pytest.mark.parametrize("n", ROWS)
def test_plan_covers_rows_and_tiles_once(n, F, want_grad):
    for m in TRAIN:
        for blocks in (1, 2):
            p = fp.plan(n, m, F, SMS, blocks, want_grad)
            # evaluation rows: blocks of BI, the last one ragged
            assert p.row_blocks * fp.BI >= n > (p.row_blocks - 1) * fp.BI or n == p.row_blocks == 0
            # training rows: tiles of BJ, the padding zero-weighted
            assert p.tiles * fp.BJ >= m > (p.tiles - 1) * fp.BJ
            # the kernel gives split s the tiles [s * tiles / S, (s + 1) * tiles / S):
            # with 1 <= S <= tiles each split gets at least one
            assert 1 <= p.splits <= p.tiles
            assert p.smem_bytes == fp.smem_bytes(F, want_grad) <= fp.SMEM_PER_BLOCK
            if p.splits > 1:
                assert p.scratch_shape == (p.splits, n * (1 + (F if want_grad else 0)))
            else:
                assert p.scratch_shape is None
            if n == 204800:
                assert p.splits == 1
            if 0 < 2 * p.row_blocks <= SMS * blocks and p.tiles >= 2:
                # rows alone leave at least half the card's block slots empty
                assert p.splits > 1


@pytest.mark.parametrize("label,n,F,want_grad,blocks,splits", [
    # the split that took the least device time in a sweep of S on an H100
    # (m = 1200, 19 tiles), or one within 7% of it
    ("g_breve d=20", 4800, 21, False, 2, 3),
    ("f_breve d=20", 1200, 21, True, 2, 10),
    ("leaf d=20", 2400, 21, False, 2, 5),
    ("g_breve d=20 full history", 10800, 21, False, 2, 3),
    ("f_breve d=20 full history", 3600, 21, True, 2, 4),
    ("g_breve d=100", 10800, 101, False, 2, 3),
    ("grad+ops d=100", 1200, 101, True, 1, 5),
])
def test_plan_picks_the_measured_split(label, n, F, want_grad, blocks, splits):
    assert fp.plan(n, 1200, F, SMS, blocks, want_grad).splits == splits


def test_plan_takes_the_occupancy_and_rejects_what_the_kernel_does_not_take():
    assert fp.plan(1200, 1200, 101, SMS, 1, True, want_ops=True).blocks_per_sm == 1
    # fewer resident blocks leave more room for splits
    assert (fp.plan(1200, 1200, 21, SMS, 1, True).splits
            <= fp.plan(1200, 1200, 21, SMS, 2, True).splits)
    for F in (1, 257):
        with pytest.raises(ValueError):
            fp.plan(10, 10, F, SMS, 2)
    with pytest.raises(ValueError):
        fp.plan(10, 0, 21, SMS, 2)
    with pytest.raises(ValueError):
        fp.plan(10, 10, 21, SMS, 0)


@pytest.mark.parametrize("n_dom,n_bdy", [(70, 30), (1000, 200), (3, 1)])
def test_prepare_inputs_layout(n_dom, n_bdy):
    """cols holds y feature-major, then r1, r3, r4, r5 and the row stats,
    zero-padded to a multiple of the 64-row tile; a boundary row has weights
    (r2, 0, 0, 0)."""
    d = 5
    rng = np.random.default_rng(n_dom)
    x_dom = torch.from_numpy(rng.uniform(-0.5, 0.5, (n_dom, d + 1)).astype(np.float32))
    x_bdy = torch.from_numpy(rng.uniform(-0.5, 0.5, (n_bdy, d + 1)).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=4 * n_dom + n_bdy).astype(np.float32))
    fused = fp.prepare_inputs(x_dom, x_bdy, r, kernel_gammas(0.25, d), d)
    m, F = n_dom + n_bdy, d + 1
    y = torch.cat([x_dom, x_bdy])
    assert fused.cols.shape == (F + fp.RECORD, -(-m // fp.BJ) * fp.BJ)
    assert fused.cols.is_contiguous()
    torch.testing.assert_close(fused.cols[:F, :m], y.T, rtol=0, atol=0)
    torch.testing.assert_close(fused.cols[F:F + 4, :m], fused.r.T, rtol=0, atol=0)
    torch.testing.assert_close(fused.cols[F + 4:, :m], fused.y_stats.T, rtol=0, atol=0)
    assert torch.all(fused.cols[:, m:] == 0)
    torch.testing.assert_close(fused.r[:n_dom, 0], r[:n_dom], rtol=0, atol=0)
    torch.testing.assert_close(fused.r[n_dom:, 0], r[n_dom:m], rtol=0, atol=0)
    assert torch.all(fused.r[n_dom:, 1:] == 0)
    torch.testing.assert_close(fused.y_stats[:, 0], (y * y).sum(1))
    torch.testing.assert_close(fused.y_stats[:, 1], y[:, :-1].sum(1))
    torch.testing.assert_close(fused.y_stats[:, 2], y[:, -1], rtol=0, atol=0)


@pytest.mark.parametrize("want_ops", [False, True])
@pytest.mark.parametrize("want_grad", [False, True])
@pytest.mark.parametrize("F", [21, 101, 251, 256])
def test_bf16_plan_fits_and_covers_rows_and_tiles_once(F, want_grad, want_ops):
    """The bf16 variant's blocks (the tensor-core operand tiles beside the
    float32 records and, with the gradient, the float32 y tile) fit the
    H100's shared memory at every width, and its plan covers every row and
    tile once."""
    smem = fp.smem_bytes(F, want_grad, bf16=True)
    assert smem <= fp.SMEM_PER_BLOCK
    for n in ROWS:
        for m in TRAIN:
            p = fp.plan(n, m, F, SMS, 1, want_grad, want_ops, bf16=True)
            assert p.smem_bytes == smem
            assert p.row_blocks * fp.BI >= n > (p.row_blocks - 1) * fp.BI or n == p.row_blocks == 0
            assert p.tiles * fp.BJ >= m > (p.tiles - 1) * fp.BJ
            assert 1 <= p.splits <= p.tiles
            width = 1 + (F if want_grad else 0) + (3 if want_ops else 0)
            assert p.scratch_shape == ((p.splits, n * width) if p.splits > 1 else None)


@pytest.mark.parametrize("F,want_grad,smem", [
    # the kernel's layout in bytes: x stats 768; two stages of records (and
    # the float32 y tile with the gradient), rows of 68 floats; the 64 x 68
    # float A_sp tile with the gradient; bf16 tiles of 64 rows of Fp + 8
    # values: x, then y (one with the gradient, two without)
    (21, False, 768 + 2 * 7 * 272 + 3 * 64 * 40 * 2),
    (21, True, 768 + 2 * 28 * 272 + 17408 + 2 * 64 * 40 * 2),
    (256, False, 768 + 2 * 7 * 272 + 3 * 64 * 264 * 2),
    (256, True, 228832),
])
def test_bf16_smem_bytes_is_the_kernel_layout(F, want_grad, smem):
    assert fp.smem_bytes(F, want_grad, bf16=True) == smem
    # the float32 layout is the one it always was
    assert fp.smem_bytes(F, want_grad) == fp.smem_bytes(F, want_grad, bf16=False) == 4 * (
        F * 68 + 192 + 2 * (F + 7) * 68 + (64 * 68 if want_grad else 0))


@pytest.mark.parametrize("d,n_dom,n_bdy", [(5, 70, 30), (20, 1000, 200), (100, 3, 1),
                                           (250, 40, 20)])
def test_prepare_inputs_rows_bf16(d, n_dom, n_bdy):
    """The bf16 variant's operand rows: y rounded to bf16, row-major, zero
    past m and past F (padded to a multiple of 16); the float32 inputs have
    none; shard_inputs slices them as it slices cols."""
    rng = np.random.default_rng(d)
    x_dom = torch.from_numpy(rng.uniform(-0.5, 0.5, (n_dom, d + 1)).astype(np.float32))
    x_bdy = torch.from_numpy(rng.uniform(-0.5, 0.5, (n_bdy, d + 1)).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=4 * n_dom + n_bdy).astype(np.float32))
    gamma = kernel_gammas(0.25, d)
    assert fp.prepare_inputs(x_dom, x_bdy, r, gamma, d).rows_bf16 is None
    fused = fp.prepare_inputs(x_dom, x_bdy, r, gamma, d, operand_dtype=torch.bfloat16)
    m, F = n_dom + n_bdy, d + 1
    Fp = -(-F // 16) * 16
    assert fp.padded_depth(F) == Fp and Fp % 16 == 0 and F <= Fp < F + 16
    rows = fused.rows_bf16
    assert rows.dtype == torch.bfloat16 and rows.is_contiguous()
    assert rows.shape == (fused.cols.shape[1], Fp)
    assert torch.equal(rows[:m, :F], torch.cat([x_dom, x_bdy]).to(torch.bfloat16))
    assert torch.all(rows[m:] == 0) and torch.all(rows[:, F:] == 0)
    # a 'model' rank's slice: its rows, re-padded to whole tiles
    for lo, hi in ((0, m), (m // 3, m), (1, max(2, m // 2))):
        part = fp.shard_inputs(fused, lo, hi)
        assert torch.equal(part.rows_bf16[:hi - lo], rows[lo:hi])
        assert part.rows_bf16.shape == (part.cols.shape[1], Fp)
        assert torch.all(part.rows_bf16[hi - lo:] == 0)
        assert torch.equal(part.cols[:, :hi - lo], fused.cols[:, lo:hi])


def test_wrapper_takes_the_plain_version_for_cpu_tensors_without_a_launch():
    d = 3
    rng = np.random.default_rng(1)
    x_dom, x_bdy, x = (torch.from_numpy(rng.uniform(-0.5, 0.5, (k, d + 1)).astype(np.float32))
                       for k in (20, 6, 9))
    r = 0.1 * torch.from_numpy(rng.normal(size=86).astype(np.float32))
    fused = fp.prepare_inputs(x_dom, x_bdy, r, kernel_gammas(0.25, d), d)
    before = fp.launches
    out = fp.fused_posterior(x, fused, True, True)
    assert fp.launches == before
    assert out.grad.shape == (9, d + 1) and out.lap_u.shape == (9,)
