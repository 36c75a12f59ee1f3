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
round the same operands to bf16 and sum exact float32 products.
"""

import dataclasses

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
            by_smem = 233472 // (fp.smem_bytes(F, g) + 1024)
            for o in (False, True):
                for bf16 in (False, True):
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
                          cfg.gn_steps, cfg.damping, cfg.grad_tol, sol0)
    e64 = rel(posterior_block(x_test, x_dom, x_bdy, out.right_vector,
                              gp.state.gamma, 20, False, False).u[:, None])
    assert abs(e32 - e64) < 0.1 * e64, (e32, e64)


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
@pytest.mark.parametrize("d,n_dom,n_bdy", WIDTHS)
@pytest.mark.parametrize("sm_count", [1, None, 100000], ids=["S=1", "planned", "S=tiles"])
def test_bf16_kernel_matches_plain_at_width(trained, monkeypatch, d, n_dom, n_bdy,
                                            sm_count):
    """The bf16 variant at F = 21, 101 and 256 with trained weights, one
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
