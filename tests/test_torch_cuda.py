"""The fused-posterior CUDA kernel on the card, against its plain PyTorch
version, and the card's float32 factorizations (the GP's inverse, the
Cole-Hopf rbf terminal fit) against float64 ones.  Every test here is marked
``cuda`` and skips where
torch.cuda.is_available() is false.  On a GPU host (which need not have JAX,
hence --noconftest):

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

Tolerance: rtol = atol = 2e-4, the posterior's bar (tests/test_pallas.py);
kernel and plain version compute r^2 in the same norm form and differ in
summation order.  The bf16-operand variant is held to its own plain version,
``posterior_block(..., operand_dtype=torch.bfloat16)``, at the same bar: both
round the same operands to bf16 and sum exact float32 products (the kernel's
on the tensor cores, mma.sync with float32 accumulators).
"""

import dataclasses
import hashlib
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from scasml_gp_torch.gp import fused_posterior as fp
from scasml_gp_torch.gp.kernels import kernel_gamma, kernel_gammas
from scasml_gp_torch.gp.posterior import posterior_block, posterior_eval

D, N_DOM, N_BDY = 6, 70, 30
GAMMAS = [kernel_gamma(0.25, D),
          kernel_gammas(0.25, D, time_scale=0.6, ridge_scale=5.0)]
FLAGS = [(False, False), (True, False), (False, True), (True, True)]
# (d, interior rows, boundary rows): F = 21 and 101 as on the main path, and
# the widest F = 256; m = 200 is no multiple of the 64-row tile.
WIDTHS = [(20, 150, 50), (100, 150, 50), (255, 150, 50)]
# the bf16 variant also at F = 251, the high_dim path's width
BF16_WIDTHS = WIDTHS + [(250, 150, 50)]
ROWS = (301, 1337)


@pytest.fixture
def problem():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s: torch.rand(s, generator=gen, device=dev) - 0.5  # noqa: E731
    # weights at the scale of trained representer weights (see
    # tests/test_torch_posterior.py)
    r = 0.1 * torch.randn((4 * N_DOM + N_BDY,), generator=gen, device=dev)
    return rand(301, D + 1), rand(N_DOM, D + 1), rand(N_BDY, D + 1), r


@pytest.mark.cuda
@pytest.mark.parametrize("want_grad,want_ops", FLAGS)
def test_kernel_matches_plain(problem, want_grad, want_ops):
    x, x_dom, x_bdy, r = problem
    for gamma in GAMMAS:
        fused = fp.prepare_inputs(x_dom, x_bdy, r, gamma, D)
        got = fp.fused_posterior(x, fused, want_grad, want_ops)
        want = posterior_block(x, x_dom, x_bdy, r, gamma, D, want_grad, want_ops)
        for name, a, b in zip(want._fields, got, want):
            if b is None:
                assert a is None, name
                continue
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4, msg=name)


@pytest.fixture(scope="module")
def trained():
    """GPs trained on the card at each width of WIDTHS, cached per width:
    trained representer weights keep the outputs at the size the kernel
    meets on the main path."""
    cache = {}

    def get(d, n_dom, n_bdy):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        if d not in cache:
            import scasml_gp_torch as port

            dev = torch.device("cuda", 0)
            eq = port.GradDependentNonlinear(n_input=d + 1)
            x_dom, x_bdy = eq.generate_data(
                n_dom, n_bdy, torch.Generator(device=dev).manual_seed(d), device=dev)
            gp = port.GPGradDependentNonlinear(eq, port.GPConfig(gn_steps=8), device=dev)
            gp.GPsolver(x_dom, x_bdy)
            cache[d] = (eq, gp.state)
        return cache[d]

    return get


def _forced_plan(monkeypatch, sm_count):
    """Launch with plan(..., sm_count, blocks_per_sm=1): sm_count = 1 gives
    one split (S = 1), a large sm_count one split per training tile."""
    monkeypatch.setattr(
        fp, "launch_plan",
        lambda x, fused, g, o: fp.plan(x.shape[0], fused.y.shape[0], fused.dim + 1,
                                       sm_count, 1, g, o))


@pytest.mark.cuda
@pytest.mark.parametrize("d,n_dom,n_bdy", WIDTHS)
@pytest.mark.parametrize("sm_count", [1, None, 100000], ids=["S=1", "planned", "S=tiles"])
def test_kernel_matches_plain_at_width(trained, monkeypatch, d, n_dom, n_bdy, sm_count):
    """Ragged n and m, F = 21, 101 and 256, one split, the planned splits and
    one split per tile, all four specialisations, at 2e-4."""
    eq, st = trained(d, n_dom, n_bdy)
    if sm_count is not None:
        _forced_plan(monkeypatch, sm_count)
    fused = st.fused_inputs()
    gen = torch.Generator(device=st.x_dom.device).manual_seed(1)
    for n in ROWS:
        x = eq.geometry().sample_domain(gen, n, device=st.x_dom.device)
        p = fp.launch_plan(x, fused, True, True)
        if sm_count == 1:
            assert p.splits == 1
        elif sm_count is not None:
            assert p.splits == p.tiles == 4
        for flags in FLAGS:
            got = fp.fused_posterior(x, fused, *flags)
            want = posterior_block(x, st.x_dom, st.x_bdy, st.right_vector, st.gamma,
                                   d, *flags)
            for name, a, b in zip(want._fields, got, want):
                if b is None:
                    assert a is None, name
                    continue
                torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4,
                                           msg=f"{name} n={n} flags={flags}")


@pytest.mark.cuda
@pytest.mark.parametrize("d,n_dom,n_bdy", WIDTHS)
def test_kernel_is_bitwise_repeatable(trained, d, n_dom, n_bdy):
    """Two launches on the same inputs give the same bits (no atomics; the
    splits are added in a fixed order)."""
    eq, st = trained(d, n_dom, n_bdy)
    fused = st.fused_inputs()
    x = eq.geometry().sample_domain(torch.Generator(device=st.x_dom.device).manual_seed(2),
                                    1337, device=st.x_dom.device)
    assert fp.launch_plan(x, fused, True, True).splits > 1
    for flags in FLAGS:
        first = fp.fused_posterior(x, fused, *flags)
        second = fp.fused_posterior(x, fused, *flags)
        for name, a, b in zip(first._fields, first, second):
            if a is not None:
                assert torch.equal(a, b), (name, flags)


@pytest.mark.cuda
def test_plan_matches_the_kernel_layout():
    """The occupancy the wrapper reads from the runtime fits at least one
    block per SM, and no more than plan()'s shared memory per block allows
    (228 KB an SM, 1 KB of it reserved per block), at every width and
    specialisation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for F in (2, 21, 101, 256):
        for g in (False, True):
            for bf16 in (False, True):
                by_smem = 233472 // (fp.smem_bytes(F, g, bf16) + 1024)
                for o in (False, True):
                    assert 1 <= fp._occupancy(0, g, o, bf16, F) <= by_smem


@pytest.mark.cuda
def test_posterior_eval_on_cuda_launches_the_kernel_once(problem):
    x, x_dom, x_bdy, r = problem
    before = fp.launches
    out = posterior_eval(x, x_dom, x_bdy, r, GAMMAS[0], D, want_grad=True,
                         want_ops=True, chunk=64)
    torch.cuda.synchronize()
    assert fp.launches == before + 1  # chunk is ignored on the kernel path
    assert out.grad.shape == (x.shape[0], D + 1)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(problem):
    x, x_dom, x_bdy, r = problem
    fused = fp.prepare_inputs(x_dom, x_bdy, r, GAMMAS[0], D)
    with pytest.raises(TypeError):
        fp.fused_posterior(x.double(), fused)
    with pytest.raises(ValueError):
        fp.fused_posterior(x.T.contiguous().T, fused)        # not contiguous
    with pytest.raises(ValueError):
        fp.fused_posterior(x[:, :-1].contiguous(), fused)    # wrong width
    wide = fp.prepare_inputs(x_dom.new_zeros((4, 300)), x_bdy.new_zeros((2, 300)),
                             r.new_zeros(18), GAMMAS[0], 299)
    with pytest.raises(ValueError):
        fp.fused_posterior(x.new_zeros((3, 300)), wide)      # d + 1 > 256


@pytest.mark.cuda
def test_wide_kernel_factorization_matches_float64():
    """At a wide kernel the tuner picks (d=20, N=1000 + 200, ridge_scale 100,
    gamma_scale 0.1; the equilibrated Gram's condition number is ~1e7), the
    float32 C on the card trains a GP within 10% of the rel-L2 that a float64
    factorization of the same Gram gives.  The JAX package's Linv^T Linv
    route missed it by 6x here (0.117 against 0.019)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import scasml_gp_torch as port
    from scasml_gp_torch.gp.gram import gram_matrix, regularized_factorization

    dev = torch.device("cuda", 0)
    eq = port.GradDependentNonlinear(n_input=21)
    x_dom, x_bdy = eq.generate_data(
        1000, 200, torch.Generator(device=dev).manual_seed(1234), device=dev)
    x_test = torch.cat(eq.generate_test_data(
        1000, 200, torch.Generator(device=dev).manual_seed(1235), device=dev))
    exact = eq.exact_solution(x_test).double()
    cfg = port.GPConfig(ridge_scale=100.0, gamma_scale=0.1)
    gp = port.GPGradDependentNonlinear(eq, cfg, device=dev)
    gp.GPsolver(x_dom, x_bdy)
    rel = lambda u: float((u.double() - exact).norm() / exact.norm())  # noqa: E731
    e32 = rel(gp.predict(x_test))

    K = gram_matrix(x_dom, x_bdy, gp.state.gamma, 20).double()
    _, C64 = regularized_factorization(K, cfg.nugget)
    sol0 = torch.randn((3000,), generator=torch.Generator(device=dev).manual_seed(0),
                       device=dev) * cfg.init_scale
    out = gp._newton_body(C64.float(), eq.g(x_bdy)[:, 0], gp.form.rhs_f(x_dom),
                          cfg.gn_steps, cfg.damping, cfg.grad_tol, sol0, gp._newton_solve)
    e64 = rel(posterior_block(x_test, x_dom, x_bdy, out.right_vector,
                              gp.state.gamma, 20, False, False).u[:, None])
    assert abs(e32 - e64) < 0.1 * e64, (e32, e64)


def _event_ms(fn, reps=10):
    """The median over ``reps`` calls of ``fn``'s time on the card between
    two CUDA events, after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def _fallback_timings(H, B):
    """Device ms at one Newton matrix that potrf refuses (n = 3N): potrf,
    pivoted LU (``solve_ex``), the no-pivot route with its gate
    (``nopivot_solve``), and, as a yardstick only, the symmetric-indefinite
    LDL^T (``ldl_factor_ex`` + ``ldl_solve``), which the port never calls;
    and the host-clock ms of the whole fallback as a train pays it
    (``spd_first_solve``: the failed potrf and potrs, the no-pivot route,
    the gate's read)."""
    import time

    from scasml_gp_torch.gp.solver import nopivot_solve, spd_first_solve

    def ldl():
        LD, piv, _ = torch.linalg.ldl_factor_ex(H)
        return torch.linalg.ldl_solve(LD, piv, B)

    out = {"potrf": _event_ms(lambda: torch.linalg.cholesky_ex(H)),
           "solve_ex": _event_ms(lambda: torch.linalg.solve_ex(H, B)),
           "nopivot_solve": _event_ms(lambda: nopivot_solve(H, B)),
           "ldl (yardstick)": _event_ms(ldl)}
    host = []
    for _ in range(11):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spd_first_solve(H, B)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    out["spd_first_solve (host clock)"] = sorted(host)[5]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("ridge_scale, gamma_scale", [(300.0, 0.3), (0.0, 1.0)])
def test_cholesky_first_train_within_the_state_gap_limit(ridge_scale, gamma_scale):
    """At the train cell's size (d=20, N=1000 + 200), for a wide-ridge kernel
    whose Newton matrices are often indefinite and for a ridge-0 one, the
    train through the Cholesky-first Newton solve answers within 0.25 (the
    cell's ``state_gap`` limit) of the float64 posterior from its own final
    unknowns (weights C b(sol)), as a share of that posterior's root mean
    square.  Every matrix potrf refused went to the no-pivot route, which
    ran cuSOLVER's getrf without pivots (``lu_factor_ex(pivot=False)``,
    info 0 on the Jacobi-scaled matrix); at the wide ridge the gate accepted
    each one.  Prints how many of its Newton solves fell back to LU, how
    the gate split them, and at the wide ridge the fallback's timings
    (``_fallback_timings``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import scasml_gp_torch as port
    from scasml_gp_torch.gp.gram import gram_matrix, regularized_factorization
    from scasml_gp_torch.gp.solver import nopivot_solve

    dev = torch.device("cuda", 0)
    d, n = 20, 1000
    eq = port.GradDependentNonlinear(n_input=d + 1)
    x_dom, x_bdy = eq.generate_data(
        n, 200, torch.Generator(device=dev).manual_seed(1234), device=dev)
    cfg = port.GPConfig(ridge_scale=ridge_scale, gamma_scale=gamma_scale)
    gp = port.GPGradDependentNonlinear(eq, cfg, device=dev)
    pendings = []
    newton_solve = gp._newton_solve
    gp._newton_solve = lambda H, B: pendings.append(newton_solve(H, B)) or pendings[-1]
    u = gp.GPsolver(x_dom, x_bdy)[:, 0].double()
    assert gp.newton_solves == cfg.gn_steps
    assert gp.newton_nopivot_solves + gp.newton_pivoted_solves == gp.newton_lu_fallbacks
    print(f"[newton] ridge {ridge_scale} gamma {gamma_scale}: "
          f"{gp.newton_lu_fallbacks} of {gp.newton_solves} solves fell back to LU, "
          f"{gp.newton_nopivot_solves} without pivoting, {gp.newton_pivoted_solves} pivoted")

    refused = [(p.A, p.B) for p in pendings if int(torch.linalg.cholesky_ex(p.A)[1])]
    assert len(refused) == gp.newton_lu_fallbacks
    for H, B in refused:
        s = torch.rsqrt(torch.clamp_min(H.diagonal().abs(), torch.finfo(H.dtype).tiny))
        assert int(torch.linalg.lu_factor_ex(s[:, None] * H * s, pivot=False)[2]) == 0
    assert sum(bool(nopivot_solve(H, B)[1]) for H, B in refused) == gp.newton_nopivot_solves
    if ridge_scale == 300.0:
        assert gp.newton_lu_fallbacks > 0 and gp.newton_pivoted_solves == 0
        H, B = refused[0]
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            nopivot_solve(H, B)
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()})
        print(f"[newton] n = {H.shape[0]}, the no-pivot route's device ops: {names}")
        print(f"[newton] n = {H.shape[0]}, a refused Newton matrix, device ms (CUDA events, "
              "median of 10): " + ", ".join(f"{k} {v:.3f}"
                                            for k, v in _fallback_timings(H, B).items()))

    sol = gp.state.sol.double()
    z1, z3, z5 = sol[:n], sol[n:2 * n], sol[2 * n:]
    b = torch.cat([z1, eq.g(x_bdy)[:, 0].double(), z3,
                   gp.form.F(z1, z3, z5, gp.form.rhs_f(x_dom).double()), z5])
    gamma = gp.state.gamma.double()
    xd, xb = x_dom.double(), x_bdy.double()
    _, C = regularized_factorization(gram_matrix(xd, xb, gamma, d, torch.float64),
                                     cfg.nugget)
    ref = posterior_block(xd, xd, xb, C @ b, gamma, d, False, False,
                          operand_dtype=torch.float64).u
    gap = float((u - ref).abs().max() / ref.pow(2).mean().sqrt())
    assert gap < 0.25, gap


def _deferred_and_synchronous_trains(dev, ridge_scale, gamma_scale, sync_debug=False):
    """The Newton loop at the train cell's size (d=20, N=1000 + 200) on the
    card ``dev``, run with each step's Cholesky flags read behind the next
    step's Hessian and with them read at once: (gp, the deferred train, the
    synchronous train, the deferred train's PendingSolves).  With
    ``sync_debug`` the deferred train runs under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    import scasml_gp_torch as port
    from scasml_gp_torch.gp.gram import gram_matrix, regularized_factorization
    from scasml_gp_torch.gp.solver import spd_first_solve

    d, n = 20, 1000
    eq = port.GradDependentNonlinear(n_input=d + 1)
    x_dom, x_bdy = eq.generate_data(
        n, 200, torch.Generator(device=dev).manual_seed(1234), device=dev)
    cfg = port.GPConfig(ridge_scale=ridge_scale, gamma_scale=gamma_scale)
    gp = port.GPGradDependentNonlinear(eq, cfg, device=dev)
    gamma = torch.tensor(gp.gamma, dtype=torch.float32, device=dev)
    _, C = regularized_factorization(gram_matrix(x_dom, x_bdy, gamma, d), cfg.nugget)
    args = (C, eq.g(x_bdy)[:, 0], gp.form.rhs_f(x_dom), cfg.gn_steps, cfg.damping,
            cfg.grad_tol, gp._initial_point(n, dev))
    want = gp._newton_body(*args, lambda H, B: spd_first_solve(H, B)[0])
    pendings = []

    def solve(H, B):
        pendings.append(gp._newton_solve(H, B))
        return pendings[-1]

    torch.cuda.synchronize(dev)
    if sync_debug:
        torch.cuda.set_sync_debug_mode("error")
    try:
        got = gp._newton_body(*args, solve)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for name in ("sol", "right_vector", "loss_history", "grad_norm"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert gp.newton_deferred_reads == cfg.gn_steps - 1
    assert gp.newton_nopivot_solves + gp.newton_pivoted_solves == gp.newton_lu_fallbacks
    print(f"[newton] {dev} ridge {ridge_scale} gamma {gamma_scale}: {gp.newton_redos} of "
          f"{gp.newton_deferred_reads} deferred reads redone, "
          f"{gp.newton_lu_fallbacks} of {gp.newton_solves} solves by LU "
          f"({gp.newton_nopivot_solves} without pivoting, {gp.newton_pivoted_solves} pivoted)")
    return gp, got, want, pendings


@pytest.mark.cuda
@pytest.mark.parametrize("ridge_scale, gamma_scale", [(0.0, 1.0), (300.0, 0.3)])
def test_deferred_flag_reads_train_bitwise(ridge_scale, gamma_scale):
    """At the train cell's size (d=20, N=1000 + 200), the Newton loop that
    reads each step's Cholesky flags behind the next step's Hessian trains
    bit for bit as the loop that reads them at once, for a ridge-0 kernel and
    for a wide-ridge one whose steps often fall back to LU (and are redone).
    At ridge 0 the step loop drains no stream (no ``.item()``, no pageable
    copy): it runs under ``torch.cuda.set_sync_debug_mode("error")``; the
    host waits only on each flag copy's event, which that mode does not
    see."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    _, _, _, pendings = _deferred_and_synchronous_trains(
        dev, ridge_scale, gamma_scale, sync_debug=ridge_scale == 0.0)
    assert all(p._info._ready.device == dev for p in pendings)


@pytest.mark.cuda
def test_deferred_flag_reads_on_a_card_that_is_not_current():
    """A mesh rank trains on cuda:<LOCAL_RANK> without making it the current
    card: the flags' event goes behind the copy on the card that trains, not
    on the current card's stream, and the train is bitwise the synchronous
    one there."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    assert torch.cuda.current_device() != dev.index
    _, _, _, pendings = _deferred_and_synchronous_trains(dev, 300.0, 0.3)
    assert pendings and all(p._info._ready.device == dev for p in pendings)


@pytest.mark.cuda
def test_rbf_terminal_fit_matches_float64():
    """The coarse rbf Cole-Hopf surrogate for HJB at d=100 (m = 1000 + 200
    terminal centers, nugget 1e-4, a wide Gaussian kernel): its float32
    Cholesky fit on the card gives a rel-L2 within 10% of a float64
    factorization of the same squared distances and targets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import scasml_gp_torch as port
    from scasml_gp_torch.gp.cole_hopf import sq_dists, terminal_fit

    dev = torch.device("cuda", 0)
    eq = port.HJB(n_input=101)
    x_dom, x_bdy = eq.generate_data(
        1000, 200, torch.Generator(device=dev).manual_seed(1234), device=dev)
    x_test = torch.cat(eq.generate_test_data(
        1000, 200, torch.Generator(device=dev).manual_seed(1235), device=dev))
    exact = eq.exact_solution(x_test).double()
    gp = port.GPHJBColeHopf(eq, device=dev, terminal_backend="rbf")
    gp.GPsolver(x_dom, x_bdy)
    st = gp.state
    alpha64, mbar64, _ = terminal_fit(sq_dists(st.x_bdy[:, :-1]).double(),
                                      st.sol.double(), gp.width, gp.fit_nugget)
    st64 = dataclasses.replace(
        st, right_vector=alpha64.float(),
        gamma=torch.stack([st.gamma[0], st.gamma[1], mbar64.float()]))
    rel = lambda u: float((u.double().reshape(-1, 1) - exact).norm() / exact.norm())  # noqa: E731
    e32 = rel(gp.predict(x_test))
    e64 = rel(gp.posterior_u(st64, x_test).u)
    assert abs(e32 - e64) < 0.1 * e64, (e32, e64)


@pytest.mark.cuda
def test_kernel_checks_its_outputs_under_float_checks(problem):
    """The debug NaN checks cannot see inside the kernel: under FloatChecks
    the wrapper launches it once, returns the same bits, and raises naming
    itself where an output holds a NaN."""
    from scasml_gp_torch.utils.debug import FloatCheckError, FloatChecks

    x, x_dom, x_bdy, r = problem
    fused = fp.prepare_inputs(x_dom, x_bdy, r, GAMMAS[0], D)
    want = fp.fused_posterior(x, fused, True, True)
    before = fp.launches
    with FloatChecks():
        got = fp.fused_posterior(x, fused, True, True)
    assert fp.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    bad = fp.prepare_inputs(x_dom, x_bdy, torch.full_like(r, float("nan")), GAMMAS[0], D)
    with pytest.raises(FloatCheckError, match="fused_posterior"):
        with FloatChecks():
            fp.fused_posterior(x, bad)


@pytest.mark.cuda
def test_distributed_trainer_on_the_card_matches_the_cpu():
    """The dual-CG trainer's GEMVs on the card against the same train on
    the CPU: the same fixed point to float32 round-off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import scasml_gp_torch as port
    from scasml_gp_torch.gp.distributed import distributed_gpsolver

    eq = port.GradDependentNonlinear(n_input=D + 1)
    x_dom, x_bdy = eq.generate_data(200, 40, torch.Generator().manual_seed(0))
    x_eval = eq.geometry().sample_domain(torch.Generator().manual_seed(1), 300)
    preds, outs = {}, {}
    for dev in ("cpu", "cuda"):
        gp = port.GPGradDependentNonlinear(eq, port.GPConfig(), device=dev)
        outs[dev] = distributed_gpsolver(gp, x_dom, x_bdy, gn_steps=8)
        preds[dev] = gp.predict(x_eval).cpu()
    assert float(outs["cuda"].final_residual) < 1e-3
    torch.testing.assert_close(outs["cuda"].loss_history.cpu(), outs["cpu"].loss_history,
                               rtol=1e-3, atol=0)
    rel = float((preds["cuda"] - preds["cpu"]).norm() / preds["cpu"].norm())
    assert rel < 1e-3, rel


BF16 = torch.bfloat16


def _assert_outputs_close(got, want, what):
    for name, a, b in zip(want._fields, got, want):
        if b is None:
            assert a is None, name
            continue
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4, msg=f"{name} {what}")


@pytest.mark.cuda
@pytest.mark.parametrize("want_grad,want_ops", FLAGS)
def test_bf16_kernel_matches_plain(problem, want_grad, want_ops):
    """The bf16-operand variant against posterior_block with bf16 operands,
    both gammas; the launch is counted as a bf16 one."""
    x, x_dom, x_bdy, r = problem
    for gamma in GAMMAS:
        fused = fp.prepare_inputs(x_dom, x_bdy, r, gamma, D, operand_dtype=BF16)
        before = dict(fp.bf16_launches_by_flags)
        got = fp.fused_posterior(x, fused, want_grad, want_ops)
        key = (want_grad, want_ops)
        assert fp.bf16_launches_by_flags[key] == before.get(key, 0) + 1
        want = posterior_block(x, x_dom, x_bdy, r, gamma, D, want_grad, want_ops,
                               operand_dtype=BF16)
        _assert_outputs_close(got, want, f"gamma={gamma}")


@pytest.mark.cuda
@pytest.mark.parametrize("d,n_dom,n_bdy", BF16_WIDTHS)
@pytest.mark.parametrize("sm_count", [1, None, 100000], ids=["S=1", "planned", "S=tiles"])
def test_bf16_kernel_matches_plain_at_width(trained, monkeypatch, d, n_dom, n_bdy,
                                            sm_count):
    """The bf16 variant at F = 21, 101, 256 and 251 with trained weights, one
    split, the planned splits and one split per tile, all four
    specialisations, at 2e-4; and it is bitwise repeatable."""
    eq, st = trained(d, n_dom, n_bdy)
    if sm_count is not None:
        _forced_plan(monkeypatch, sm_count)
    fused = st.fused_inputs(BF16)
    gen = torch.Generator(device=st.x_dom.device).manual_seed(1)
    for n in ROWS:
        x = eq.geometry().sample_domain(gen, n, device=st.x_dom.device)
        for flags in FLAGS:
            got = fp.fused_posterior(x, fused, *flags)
            again = fp.fused_posterior(x, fused, *flags)
            want = posterior_block(x, st.x_dom, st.x_bdy, st.right_vector, st.gamma,
                                   d, *flags, operand_dtype=BF16)
            _assert_outputs_close(got, want, f"n={n} flags={flags}")
            for a, b in zip(got, again):
                assert a is None or torch.equal(a, b), flags


@pytest.mark.cuda
@pytest.mark.parametrize("d,n_dom,n_bdy", BF16_WIDTHS)
def test_bf16_call_replayed_in_a_graph_is_bitwise_eager(trained, d, n_dom, n_bdy):
    """One bf16 call of each specialisation captured in a CUDA graph (as
    the captured rollouts of picard/graphs.py capture it): the replay gives
    the eager call's bits."""
    eq, st = trained(d, n_dom, n_bdy)
    fused = st.fused_inputs(BF16)
    x = eq.geometry().sample_domain(torch.Generator(device=st.x_dom.device).manual_seed(4),
                                    1337, device=st.x_dom.device)
    for flags in FLAGS:
        eager = fp.fused_posterior(x, fused, *flags)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fp.fused_posterior(x, fused, *flags)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fp.fused_posterior(x, fused, *flags)
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            for name, a, b in zip(eager._fields, out, eager):
                assert a is None or torch.equal(a, b), (name, flags)


def _kernel_sass():
    """{kernel name: SASS} of the built library (cuobjdump)."""
    from scasml_gp_torch.utils import build

    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", build.library_path()], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return {m.group(1): m.group(2) for m in re.finditer(
        r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", text, re.S)}


@pytest.mark.cuda
def test_bf16_specialisations_run_x_dot_y_on_the_tensor_cores():
    """Every bf16 specialisation issues bf16 HMMA (mma.sync) instructions
    with float32 accumulators; no float32 one issues any."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scasml_gp_torch.utils import build

    build.load_library()
    kernels = {k: v for k, v in _kernel_sass().items() if "fused_posterior_kernel" in k}
    bf16 = {k: v for k, v in kernels.items() if re.search(r"Li\d+ELb1E", k)}
    fp32 = {k: v for k, v in kernels.items() if re.search(r"Li\d+ELb0E", k)}
    assert len(bf16) == len(fp32) == 10, sorted(kernels)
    for name, sass in bf16.items():
        assert re.search(r"HMMA\.16816\.F32\.BF16", sass), name
    for name, sass in fp32.items():
        assert "HMMA" not in sass, name


# The float32 specialisations' outputs at F = 21, hashed: the digests of
# the kernel before its bf16 specialisations moved to the tensor cores
# (NVIDIA H100 80GB HBM3), which left the float32 ones as they were.
PARENT_FLOAT32_DIGESTS = {
    "00": {"u": "874a9ef77d942c64"},
    "10": {"u": "717e4450d2a2764c", "grad": "fc5db632e05341a0"},
    "01": {"u": "874a9ef77d942c64", "dt_u": "1268a5e7303bb3f1", "div_u": "6e1b64274b2b1cd8",
           "lap_u": "c9d774880cfd0ee9"},
    "11": {"u": "717e4450d2a2764c", "grad": "fc5db632e05341a0", "dt_u": "1268a5e7303bb3f1",
           "div_u": "6e1b64274b2b1cd8", "lap_u": "c9d774880cfd0ee9"},
}


def float32_digests():
    """SHA-256 (first 16 hex digits) of each output of each float32
    specialisation at F = 21 on seeded numpy inputs, n = 1337 rows against
    150 + 50 training rows (three splits on an H100)."""
    rng = np.random.default_rng(21)
    dev = torch.device("cuda", 0)
    x, x_dom, x_bdy = (torch.from_numpy(rng.uniform(-0.5, 0.5, (k, 21)).astype(np.float32))
                       .to(dev) for k in (1337, 150, 50))
    r = torch.from_numpy(0.1 * rng.normal(size=650).astype(np.float32)).to(dev)
    fused = fp.prepare_inputs(x_dom, x_bdy, r, kernel_gamma(0.25, 20), 20)
    out = {}
    for flags in FLAGS:
        got = fp.fused_posterior(x, fused, *flags)
        torch.cuda.synchronize()
        out[f"{flags[0]:d}{flags[1]:d}"] = {
            name: hashlib.sha256(a.cpu().numpy().tobytes()).hexdigest()[:16]
            for name, a in zip(got._fields, got) if a is not None}
    return out


@pytest.mark.cuda
def test_float32_kernel_is_bitwise_the_pinned_outputs():
    """The float32 specialisations give the pinned outputs bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert float32_digests() == PARENT_FLOAT32_DIGESTS


@pytest.mark.cuda
def test_bf16_posterior_eval_through_the_gp(trained):
    """A GP with the bf16 policy evaluates through the bf16 variant (its own
    cached inputs beside the float32 ones) and stays near the float32
    posterior."""
    import scasml_gp_torch as port

    eq, st = trained(20, 150, 50)
    gp = port.GPGradDependentNonlinear(
        eq, port.GPConfig(), precision=port.PrecisionPolicy(gram="bfloat16"),
        device=st.x_dom.device)
    gp.state = st
    x = eq.geometry().sample_domain(torch.Generator(device=st.x_dom.device).manual_seed(3),
                                    500, device=st.x_dom.device)
    fp.reset_launches()
    u16 = gp.posterior_u(st, x, want_grad=True).u
    assert fp.bf16_launches_by_flags == {(True, False): 1} and not fp.launches_by_flags
    u32 = fp.fused_posterior(x, st.fused_inputs(), True).u
    rel = float((u16 - u32).norm() / u32.norm())
    assert rel < 2e-2, rel


# The captured rollouts (picard/graphs.py) on the bench equation at a small
# width: a replay runs the eager rollout's kernels with the same Philox
# offsets, so it gives the same bits from one generator state.

@pytest.fixture(scope="module")
def bench_gp():
    """The bench workload's GP at d = D on the card, and 300 test points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import scasml_gp_torch as port

    dev = torch.device("cuda", 0)
    eq = port.GradDependentNonlinear(n_input=D + 1)
    gp = port.GPGradDependentNonlinear(eq, port.GPConfig(gn_steps=8), device=dev)
    gp.GPsolver(*eq.generate_data(150, 40, torch.Generator(device=dev).manual_seed(0),
                                  device=dev))
    x = eq.geometry().sample_domain(torch.Generator(device=dev).manual_seed(1), 300,
                                    device=dev)
    return eq, gp, x


def _solver(kind, eq, gp):
    """A solver of ``kind`` on the bench GP, and its rollout call."""
    import scasml_gp_torch as port

    if kind == "quadrature":
        return port.ScaSML(eq, gp, seed=3), lambda s, x: s.uz_solve(2, 2, x)
    if kind == "mlp_quadrature":
        return port.MLP(eq, device=gp.device, seed=3), lambda s, x: s.uz_solve(2, 2, x)
    if kind == "mlp_full_history":
        return (port.MLPFullHistory(eq, device=gp.device, seed=3),
                lambda s, x: s.uz_solve(2, None, x, M=3))
    # bf16 paths: the low-precision normals' constants inside the graph
    precision = port.PrecisionPolicy(rollout="bfloat16") if kind.endswith("bf16") else None
    return (port.ScaSMLFullHistory(eq, gp, seed=3, precision=precision),
            lambda s, x: s.uz_solve(2, None, x, M=3))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["quadrature", "full_history", "mlp_quadrature",
                                  "mlp_full_history", "full_history_bf16"])
def test_graphed_rollout_is_bitwise_eager(bench_gp, kind):
    """Warm-up, capture and replays each equal the eager rollout from the
    same generator state, after manual_seed(s) for two seeds; the generator
    ends where an eager call leaves it; every replay counts the eager
    call's kernel launches."""
    eq, gp, x = bench_gp
    sca, solve = _solver(kind, eq, gp)
    assert sca.eager_reason() is None
    for seed in (5, 11):
        with sca._eager():
            sca.gen.manual_seed(seed)
            fp.reset_launches()
            want = solve(sca, x)
            torch.cuda.synchronize()
            launches, state = dict(fp.launches_by_flags), sca.gen.get_state()
        for _ in range(3):
            sca.gen.manual_seed(seed)
            fp.reset_launches()
            got = solve(sca, x)
            torch.cuda.synchronize()
            assert torch.equal(got, want), float((got - want).abs().max())
            assert fp.launches_by_flags == launches
            assert torch.equal(sca.gen.get_state(), state)
    assert sca._graphs.captures == 1 and sca._graphs.replays == 5


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["quadrature", "full_history"])
def test_guarded_solve_with_probes_is_bitwise_eager(bench_gp, variant):
    """The variance guard's main rollout and its two half-sample probes
    replay graphs; lambda, read on the host after the replays, and the
    solve equal the eager ones from the same generator state."""
    import scasml_gp_torch as port

    eq, gp, x = bench_gp
    if variant == "quadrature":
        sca = port.ScaSML(eq, gp, seed=3, variance_guard=True)
        solve = lambda: sca.u_solve(2, 2, x)  # noqa: E731
    else:
        sca = port.ScaSMLFullHistory(eq, gp, seed=3, variance_guard=True)
        solve = lambda: sca.u_solve(2, None, x, M=4)  # noqa: E731
    with sca._eager():
        sca.gen.manual_seed(8)
        want, lam = solve(), sca.last_lambda
    for _ in range(3):
        sca.gen.manual_seed(8)
        assert torch.equal(solve(), want) and sca.last_lambda == lam
    assert len(sca._graphs.captured_keys()) == 2  # the main tree and the probes'


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["quadrature", "full_history"])
def test_graphs_follow_a_replaced_state(bench_gp, kind):
    """A new trained state is captured anew: the graphed rollout equals the
    new state's eager one, and the old state's graph is gone."""
    eq, gp, x = bench_gp
    sca, solve = _solver(kind, eq, gp)
    for _ in range(3):
        solve(sca, x)
    old = gp.state
    gp.state = dataclasses.replace(old, right_vector=0.5 * old.right_vector, _fused={})
    try:
        with sca._eager():
            sca.gen.manual_seed(7)
            want = solve(sca, x)
        for _ in range(3):
            sca.gen.manual_seed(7)
            assert torch.equal(solve(sca, x), want)
        assert sca._graphs.captures == 2 and len(sca._graphs.captured_keys()) == 1
        assert sca._graphs._params is gp.state
    finally:
        gp.state = old


@pytest.mark.cuda
@pytest.mark.parametrize("sync", ["item", "host copy"])
def test_capture_that_syncs_raises(bench_gp, sync):
    """A rollout that waits for the device or copies from the host inside
    the capture raises GraphCaptureError naming the line; it is never run
    eagerly instead, and the next call tries the capture again."""
    from scasml_gp_torch.picard.graphs import GraphCaptureError

    eq, gp, x = bench_gp
    sca, solve = _solver("full_history", eq, gp)
    build = sca._build

    def rollout(key):
        fn = build(key)

        def synced(x_t, gen, params):
            out = fn(x_t, gen, params)
            if sync == "item":
                return out * float(out.abs().max())
            return out * torch.as_tensor(np.array([2.0], np.float32), device=out.device)

        return synced

    sca._get_fn = rollout
    solve(sca, x)  # the eager warm-up runs
    for _ in range(2):
        with pytest.raises(GraphCaptureError, match="float\\(out|torch.as_tensor\\(np.array"):
            solve(sca, x)
    assert sca._graphs.captures == 0 and sca._graphs.replays == 0


# The marginal-likelihood fit's batched rounds (gp/marginal.py): on the card
# an Adam step is captured once per fit and replayed.

@pytest.fixture(scope="module")
def fit_problem():
    """GradDependentNonlinear at d = D on the card: 150 + 40 points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import scasml_gp_torch as port

    dev = torch.device("cuda", 0)
    eq = port.GradDependentNonlinear(n_input=D + 1)
    x_dom, x_bdy = eq.generate_data(150, 40, torch.Generator(device=dev).manual_seed(2),
                                    device=dev)
    return eq, x_dom, x_bdy, port.GPConfig(gn_steps=8)


def _fit(fit_problem, **kw):
    import scasml_gp_torch as port
    from scasml_gp_torch.gp import marginal as pm

    eq, x_dom, x_bdy, base = fit_problem
    return pm.fit_gp_marginal_likelihood(port.GPGradDependentNonlinear, eq, x_dom, x_bdy,
                                         base=base, outer_rounds=3, inner_steps=10, **kw)


@pytest.mark.cuda
def test_graphed_fit_rounds_are_bitwise_eager(fit_problem, monkeypatch):
    """The fit's Adam steps replay one graph captured once per fit call;
    the history, the candidates and the shipped config are bitwise the
    eager batched fit's."""
    from scasml_gp_torch.gp import marginal as pm

    captures = []
    capture = pm._capture
    monkeypatch.setattr(pm, "_capture", lambda *a, **kw: captures.append(1) or capture(*a, **kw))
    assert pm.eager_reason(fit_problem[1].device) is None
    with pm._eager():
        want = _fit(fit_problem)
    assert captures == []
    for fits in (1, 2):
        got = _fit(fit_problem)
        assert len(captures) == fits
        assert np.array_equal(got.history, want.history), np.abs(got.history - want.history).max()
        assert [(c, n) for c, n, _ in got.table][1:] == [(c, n) for c, n, _ in want.table][1:]
        assert got.config == want.config


@pytest.mark.cuda
def test_batched_fit_matches_the_per_restart_loop(fit_problem):
    """The batched fit's NLML history against the per-restart loop it
    replaced (one Newton train and one torch.optim.Adam per restart and
    round, inlined here), within 1e-3 relative."""
    from scasml_gp_torch.gp import marginal as pm

    import scasml_gp_torch as port

    eq, x_dom, x_bdy, base = fit_problem
    got = _fit(fit_problem)
    gp = port.GPGradDependentNonlinear(eq, base, device=x_dom.device)
    bdy_g = eq.g(x_bdy)[:, 0]
    rhs = gp.form.rhs_f(x_dom)
    sigma, N = float(eq.sigma()), x_dom.shape[0]
    theta0 = torch.as_tensor(pm._initial_thetas(base, (0.0, 3.0, 10.0, 30.0), ()),
                             device=x_dom.device)
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0], device=x_dom.device)
    thetas, history = list(theta0), []
    for _ in range(3):
        finals = []
        for i, t0 in enumerate(theta0):
            with torch.no_grad():
                sol = gp._train(x_dom, x_bdy, bdy_g, rhs, pm._gamma_of(thetas[i], sigma, D),
                                pm._theta_to_params(thetas[i])[3], base.gn_steps,
                                base.damping, base.grad_tol).sol
                z1, z3, z5 = sol[:N], sol[N:2 * N], sol[2 * N:]
                b = torch.cat([z1, bdy_g, z3, gp.form.F(z1, z3, z5, rhs), z5])
            theta = thetas[i].detach().clone().requires_grad_(True)
            opt = torch.optim.Adam([theta], lr=0.08, betas=(0.9, 0.999), eps=1e-8)
            for _ in range(10):
                opt.zero_grad(set_to_none=True)
                obj = pm._nlml(theta, b, x_dom, x_bdy, sigma, D) \
                    + 0.5 * 2.0 * torch.sum((theta - t0) ** 2)
                obj.backward()
                g = theta.grad
                theta.grad = torch.where(torch.isfinite(g), g, torch.zeros_like(g)) * mask
                opt.step()
            thetas[i] = theta.detach()
            with torch.no_grad():
                finals.append(float(pm._nlml(thetas[i], b, x_dom, x_bdy, sigma, D)))
        history.append(finals)
    assert got.history.shape == (3, 4)
    np.testing.assert_allclose(got.history, np.array(history), rtol=1e-3)


@pytest.mark.cuda
def test_captured_fit_round_makes_no_host_sync(fit_problem):
    """A round of the graphed Adam (the copies into the graph's buffers, the
    capture, the replays) runs under set_sync_debug_mode('error')."""
    import scasml_gp_torch as port
    from scasml_gp_torch.gp import marginal as pm

    eq, x_dom, x_bdy, base = fit_problem
    gp = port.GPGradDependentNonlinear(eq, base, device=x_dom.device)
    sigma = float(eq.sigma())
    theta0 = torch.as_tensor(pm._initial_thetas(base, (0.0, 3.0, 10.0, 30.0), ()),
                             device=x_dom.device)
    b = pm._train_latents(gp, theta0, x_dom, x_bdy, eq.g(x_bdy)[:, 0],
                          gp.form.rhs_f(x_dom), sigma, base.gn_steps, base)
    adam = pm._MapAdam(lambda t, bb: pm._nlml(t, bb, x_dom, x_bdy, sigma, D), theta0, 5,
                       0.08, 2.0, torch.tensor([1.0, 1.0, 1.0, 0.0], device=x_dom.device),
                       graphed=True)
    try:
        first = adam(theta0, b)  # eager: the warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            second = adam(theta0, b)  # captures, then replays
            third = adam(theta0, b)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert adam.graph is not None
        assert torch.equal(second, first) and torch.equal(third, first)
    finally:
        adam.close()
