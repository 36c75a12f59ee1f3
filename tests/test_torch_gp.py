"""Port's equation and GP trainer (scasml_gp_torch.equations,
scasml_gp_torch.gp.solver) against the JAX package on the same points.

Both trainers get the same initial point: the port receives as ``sol0`` the
draw the JAX trainer makes internally (PRNGKey(0) normals times init_scale).
Tolerance: relative 1e-3.  Each side factors the same float32 Gram; the
equilibrated inverse carries ~1e-5 relative round-off (condition number ~1e2
times float32 epsilon), which the Newton steps carry into the loss and the
weights.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import scasml_gp_torch as port  # noqa: E402
from scasml_gp_tpu.config import GPConfig as JaxGPConfig  # noqa: E402
from scasml_gp_tpu.equations import GradDependentNonlinear as JaxEq  # noqa: E402
from scasml_gp_tpu.gp import GPGradDependentNonlinear as JaxGP  # noqa: E402

torch.set_num_threads(2)

D, N, NB, STEPS = 4, 60, 20, 12
REL = 1e-3


def _rel_l2(pred, exact):
    pred, exact = np.ravel(pred), np.ravel(exact)
    return np.linalg.norm(pred - exact) / np.linalg.norm(exact)


@pytest.fixture(scope="module")
def trained():
    rng = np.random.default_rng(11)
    eq_j = JaxEq(n_input=D + 1)
    x_dom, x_bdy = (np.array(a) for a in
                    eq_j.generate_data(N, NB, key=jax.random.PRNGKey(4)))
    x_test = rng.uniform(-0.5, 0.5, (80, D + 1)).astype(np.float32)
    x_test[:, -1] = rng.uniform(0.0, 0.5, 80)

    gp_j = JaxGP(eq_j, JaxGPConfig(gn_steps=STEPS))
    gp_j.GPsolver(jnp.asarray(x_dom), jnp.asarray(x_bdy))
    sol0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (3 * N,))) * 1e-3

    eq_t = port.GradDependentNonlinear(n_input=D + 1)
    gp_t = port.GPGradDependentNonlinear(eq_t, port.GPConfig(gn_steps=STEPS), device="cpu")
    gp_t.GPsolver(torch.from_numpy(x_dom), torch.from_numpy(x_bdy),
                  sol0=torch.from_numpy(sol0.astype(np.float32)))
    return gp_j, gp_t, x_test


def test_loss_history_matches_jax(trained):
    gp_j, gp_t, _ = trained
    want = np.asarray(gp_j.state.loss_history)
    got = gp_t.state.loss_history.numpy()
    assert got.shape == want.shape == (STEPS + 1,)
    np.testing.assert_allclose(got, want, rtol=REL)
    assert got[-1] < 0.1 * got[0]


def test_weights_match_jax(trained):
    gp_j, gp_t, _ = trained
    for name in ("right_vector", "sol"):
        want = np.asarray(getattr(gp_j.state, name))
        got = getattr(gp_t.state, name).numpy()
        assert np.abs(got - want).max() <= REL * np.abs(want).max(), name
    np.testing.assert_allclose(gp_t.state.gamma.numpy(),
                               np.asarray(gp_j.gamma, np.float32), rtol=0)


def test_rel_l2_matches_jax(trained):
    gp_j, gp_t, x_test = trained
    exact = np.asarray(gp_j.equation.exact_solution(jnp.asarray(x_test)))
    e_j = _rel_l2(np.asarray(gp_j.predict(jnp.asarray(x_test))), exact)
    e_t = _rel_l2(gp_t.predict(torch.from_numpy(x_test)).numpy(), exact)
    assert abs(e_t - e_j) <= REL * e_j, (e_t, e_j)
    assert e_t < 0.2


def test_gradient_and_residual_match_jax(trained):
    """compute_gradient / compute_PDE_loss are weighted sums of the weights,
    which agree to 1e-3 of their largest entry; so do these outputs."""
    gp_j, gp_t, x_test = trained
    xj, xt = jnp.asarray(x_test), torch.from_numpy(x_test)
    for got, want in (
        (gp_t.compute_gradient(xt), gp_j.compute_gradient(xj)),
        (gp_t.compute_PDE_loss(xt), gp_j.compute_PDE_loss(xj)),
    ):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= REL * max(np.abs(want).max(), 1.0)


def test_unported_train_paths_raise():
    """The parity modes and the bf16 Gram raise; the distributed trainer,
    once among them, is ported (tests/test_torch_distributed.py) and takes
    over past dense_phi_max; an untrained GP refuses to predict."""
    eq = port.GradDependentNonlinear(n_input=D + 1)
    x = torch.zeros((3, D + 1))
    with pytest.raises(NotImplementedError):
        port.GPGradDependentNonlinear(eq, port.GPConfig(laplacian="subset"), device="cpu")
    with pytest.raises(NotImplementedError):
        port.GPGradDependentNonlinear(eq, port.GPConfig(parity_fp16=True), device="cpu")
    with pytest.raises(NotImplementedError):
        port.GPGradDependentNonlinear(eq, precision=port.PrecisionPolicy(gram="bfloat16"),
                                      device="cpu")
    gp = port.GPGradDependentNonlinear(eq, port.GPConfig(dense_phi_max=8), device="cpu")
    with pytest.raises(RuntimeError):
        gp.predict(x)
    gp.GPsolver(*eq.generate_data(20, 6, torch.Generator().manual_seed(0)))
    assert gp.state.loss_history.shape == (gp.config.dist_gn_steps + 1,)


def test_closed_forms_match_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.5, 0.5, (16, D + 1)).astype(np.float32)
    u = rng.normal(size=(16, 1)).astype(np.float32)
    z = rng.normal(size=(16, D)).astype(np.float32)
    eq_t, eq_j = port.GradDependentNonlinear(D + 1), JaxEq(D + 1)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    pairs = [
        (eq_t.f(xt, torch.from_numpy(u), torch.from_numpy(z)),
         eq_j.f(xj, jnp.asarray(u), jnp.asarray(z))),
        (eq_t.g(xt), eq_j.g(xj)),
        (eq_t.exact_solution(xt), eq_j.exact_solution(xj)),
        (eq_t.exact_solution_derivative(xt), eq_j.exact_solution_derivative(xj)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    assert eq_t.mu() == eq_j.mu() and eq_t.sigma() == eq_j.sigma()
    assert (eq_t.uncertainty, eq_t.norm_estimation, eq_t.T) == (
        eq_j.uncertainty, eq_j.norm_estimation, eq_j.T)


def test_samplers_range_facets_and_determinism():
    eq = port.GradDependentNonlinear(n_input=D + 1)
    draw = lambda: eq.generate_data(  # noqa: E731
        50, 40, torch.Generator().manual_seed(5))
    x_dom, x_bdy = draw()
    assert x_dom.shape == (50, D + 1) and x_bdy.shape == (40, D + 1)
    assert x_dom.dtype == torch.float32
    assert torch.all(x_dom[:, :-1].abs() <= 0.5)
    assert torch.all((x_dom[:, -1] >= 0.0) & (x_dom[:, -1] <= 0.5))
    # every boundary point lies on a facet (|x_i| = 0.5)
    on_facet = (x_bdy[:, :-1].abs() == 0.5).sum(1)
    assert torch.all(on_facet >= 1)
    assert torch.all((x_bdy[:, -1] >= 0.0) & (x_bdy[:, -1] <= 0.5))
    again = draw()
    assert torch.equal(x_dom, again[0]) and torch.equal(x_bdy, again[1])
    other = eq.generate_data(50, 40, torch.Generator().manual_seed(6))
    assert not torch.equal(x_dom, other[0])
    x_term = eq.geometry().sample_terminal(torch.Generator().manual_seed(0), 8)
    assert torch.all(x_term[:, -1] == eq.T)
