"""The fused-posterior CUDA kernel on the card, against its plain PyTorch
version, and the card's float32 factorizations (the GP's inverse, the
Cole-Hopf rbf terminal fit) against float64 ones.  Every test here is marked
``cuda`` and skips where
torch.cuda.is_available() is false.  On a GPU host (which need not have JAX,
hence --noconftest):

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

Tolerance: rtol = atol = 2e-4, the posterior's bar (tests/test_pallas.py);
kernel and plain version differ in summation order and in how r^2 is formed.
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
