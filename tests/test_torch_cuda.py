"""The fused-posterior CUDA kernel on the card, against its plain PyTorch
version.  Every test here is marked ``cuda`` and skips where
torch.cuda.is_available() is false.  On a GPU host (which need not have JAX,
hence --noconftest):

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

Tolerance: rtol = atol = 2e-4, the posterior's bar (tests/test_pallas.py);
kernel and plain version differ in summation order and in how r^2 is formed.
"""

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
