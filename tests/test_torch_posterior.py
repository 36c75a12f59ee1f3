"""Port's posterior (scasml_gp_torch.gp.posterior and the plain twin of the
CUDA kernel in gp.fused_posterior) against the JAX package's posterior_eval
and the archived Pallas kernel (interpret mode on the CPU).

Tolerance: rtol = atol = 2e-4, the bar the Pallas kernel met against XLA
(tests/test_pallas.py).  All versions compute the same float32 function;
they differ in summation order and in how r^2 is formed.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from scasml_gp_torch.gp import fused_posterior as tfp  # noqa: E402
from scasml_gp_torch.gp.kernels import kernel_gamma, kernel_gammas  # noqa: E402
from scasml_gp_torch.gp.posterior import posterior_block, posterior_eval  # noqa: E402
from scasml_gp_torch.gp.state import load_state, state_from_numpy  # noqa: E402
from scasml_gp_tpu.gp.posterior import posterior_eval as jax_posterior_eval  # noqa: E402

torch.set_num_threads(2)

D = 4
N_DOM, N_BDY, N_EVAL = 70, 30, 45
RTOL = ATOL = 2e-4
GAMMAS = {
    "isotropic": kernel_gamma(0.25, D),
    "separable+ridge": kernel_gammas(0.25, D, time_scale=0.6, ridge_scale=5.0),
}
FLAGS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    x_dom = rng.uniform(-0.5, 0.5, (N_DOM, D + 1)).astype(np.float32)
    x_bdy = rng.uniform(-0.5, 0.5, (N_BDY, D + 1)).astype(np.float32)
    x = rng.uniform(-0.5, 0.5, (N_EVAL, D + 1)).astype(np.float32)
    # Weights at the scale of trained representer weights (rms ~0.09 for the
    # bench GP).  Unit weights give outputs of size 1e3 whose near-zero
    # rows no two float32 summation orders match to 2e-4 absolute.
    r = 0.1 * rng.normal(size=(4 * N_DOM + N_BDY,)).astype(np.float32)
    return x, x_dom, x_bdy, r


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _assert_same(got, want):
    for name, a, b in zip(want._fields, got, want):
        if b is None:
            assert a is None, name
            continue
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("gname", list(GAMMAS))
@pytest.mark.parametrize("want_grad,want_ops", FLAGS)
def test_plain_matches_jax(problem, gname, want_grad, want_ops):
    gamma = GAMMAS[gname]
    want = jax_posterior_eval(*(jnp.asarray(a) for a in problem), gamma, D,
                              want_grad=want_grad, want_ops=want_ops)
    got = posterior_eval(*_t(*problem), gamma, D, want_grad=want_grad,
                         want_ops=want_ops)
    _assert_same(got, want)


@pytest.mark.parametrize("want_grad,want_ops", FLAGS)
def test_plain_matches_pallas_interpret(problem, want_grad, want_ops):
    from scripts.pallas_posterior import posterior_eval_fused

    for gamma in GAMMAS.values():
        want = posterior_eval_fused(*(jnp.asarray(a) for a in problem), gamma,
                                    D, want_grad=want_grad, want_ops=want_ops)
        got = posterior_eval(*_t(*problem), gamma, D, want_grad=want_grad,
                             want_ops=want_ops)
        _assert_same(got, want)


@pytest.mark.parametrize("want_grad,want_ops", FLAGS)
def test_stacked_boundary_form_matches_plain(problem, want_grad, want_ops):
    """The kernel's reformulation (boundary rows folded into the training set
    with weights (r2, 0, 0, 0)) equals the two-set posterior, and the
    wrapper takes it for CPU tensors without counting a launch."""
    x, x_dom, x_bdy, r = _t(*problem)
    for gamma in GAMMAS.values():
        fused = tfp.prepare_inputs(x_dom, x_bdy, r, gamma, D)
        assert fused.y.shape == (N_DOM + N_BDY, D + 1)
        assert torch.all(fused.r[N_DOM:, 1:] == 0)
        want = posterior_block(x, x_dom, x_bdy, r, gamma, D, want_grad, want_ops)
        before = tfp.launches
        got = tfp.fused_posterior(x, fused, want_grad, want_ops)
        assert tfp.launches == before
        _assert_same(got, want)


@pytest.mark.parametrize("gname", list(GAMMAS))
@pytest.mark.parametrize("want_grad,want_ops", FLAGS)
def test_stacked_with_row_stats_matches_jax(problem, gname, want_grad, want_ops):
    """The kernel's plain twin on the prepared inputs (the training rows'
    |y|^2, spatial sum and time precomputed once) gives the JAX package's
    posterior."""
    gamma = GAMMAS[gname]
    x, x_dom, x_bdy, r = _t(*problem)
    fused = tfp.prepare_inputs(x_dom, x_bdy, r, gamma, D)
    got = tfp.stacked_posterior(x, fused, want_grad, want_ops)
    want = jax_posterior_eval(*(jnp.asarray(a) for a in problem), gamma, D,
                              want_grad=want_grad, want_ops=want_ops)
    _assert_same(got, want)


def test_ragged_rows_and_chunk_path(problem):
    """n = 300 is no multiple of the chunk of 64; the chunked CPU path equals
    one block and the JAX package's chunked evaluation."""
    x, x_dom, x_bdy, r = problem
    xL = np.tile(x, (7, 1))[:300]
    gamma = GAMMAS["separable+ridge"]
    whole = posterior_eval(*_t(xL, x_dom, x_bdy, r), gamma, D, want_grad=True,
                           want_ops=True)
    chunked = posterior_eval(*_t(xL, x_dom, x_bdy, r), gamma, D, want_grad=True,
                             want_ops=True, chunk=64)
    want = jax_posterior_eval(*(jnp.asarray(a) for a in (xL, x_dom, x_bdy, r)),
                              gamma, D, want_grad=True, want_ops=True, chunk=64)
    for a, b in zip(chunked, whole):
        assert a.shape == b.shape
    _assert_same(chunked, whole)
    _assert_same(chunked, want)


def test_unported_options_raise(problem):
    args = _t(*problem)
    with pytest.raises(NotImplementedError):
        posterior_eval(*args, GAMMAS["isotropic"], D, operand_dtype="bfloat16")
    with pytest.raises(NotImplementedError):
        posterior_eval(*args, GAMMAS["isotropic"], D, shard_dom=object())


@pytest.fixture(scope="module")
def jax_gp():
    from scasml_gp_tpu.config import GPConfig
    from scasml_gp_tpu.equations import GradDependentNonlinear
    from scasml_gp_tpu.gp import GPGradDependentNonlinear

    eq = GradDependentNonlinear(n_input=D + 1)
    gp = GPGradDependentNonlinear(eq, GPConfig(gn_steps=6, ridge_scale=2.0))
    x_dom, x_bdy = eq.generate_data(40, 12, key=jax.random.PRNGKey(0))
    gp.GPsolver(x_dom, x_bdy)
    x_test, _ = eq.generate_test_data(50, 1, key=jax.random.PRNGKey(1))
    return gp, np.array(x_test)


def test_jax_trained_state_through_npz(jax_gp, tmp_path):
    """A state trained and saved by the JAX package, loaded by the port,
    gives the JAX posterior on every output."""
    from scasml_gp_tpu.gp.state import save_state

    gp, x_test = jax_gp
    path = str(tmp_path / "state.npz")
    save_state(path, gp.state)
    st = load_state(path, device="cpu")
    assert st.x_dom.dtype == torch.float32 and st.gamma.shape == (3,)
    s = gp.state
    want = jax_posterior_eval(jnp.asarray(x_test), s.x_dom, s.x_bdy,
                              s.right_vector, s.gamma, D, want_grad=True,
                              want_ops=True)
    got = posterior_eval(torch.from_numpy(x_test), st.x_dom, st.x_bdy,
                         st.right_vector, st.gamma, D, want_grad=True,
                         want_ops=True)
    _assert_same(got, want)


def test_state_from_numpy_carries_weights(jax_gp):
    gp, x_test = jax_gp
    arrays = {k: np.asarray(v) for k, v in gp.state._asdict().items()}
    st = state_from_numpy(arrays, "cpu")
    for k, v in arrays.items():
        np.testing.assert_array_equal(getattr(st, k).numpy(), v)
    fused = st.fused_inputs()
    assert st.fused_inputs() is fused  # cached once per state
    got = tfp.fused_posterior(torch.from_numpy(x_test), fused, True, True)
    want = jax_posterior_eval(jnp.asarray(x_test), gp.state.x_dom,
                              gp.state.x_bdy, gp.state.right_vector,
                              gp.state.gamma, D, want_grad=True, want_ops=True)
    _assert_same(got, want)
    with pytest.raises(KeyError):
        state_from_numpy({"x_dom": arrays["x_dom"]}, "cpu")
