"""Port's Cole-Hopf HJB surrogate (scasml_gp_torch.gp.cole_hopf) against the
JAX package.

The rbf centers are drawn from a JAX key, which torch cannot replay, so the
posterior is compared on states trained by the JAX package and carried over
with ``state_from_numpy``, and the rbf fit is compared from the JAX
package's own centers.  The mixture backend draws nothing and is compared
from training.  Tolerance rtol = atol = 2e-4, the posterior's bar
(tests/test_pallas.py): the (n, m) distances are formed the same way, the
sums run in another order.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import scasml_gp_torch as port  # noqa: E402
from scasml_gp_torch.gp import cole_hopf as tch  # noqa: E402
from scasml_gp_torch.gp.state import state_from_numpy  # noqa: E402
from scasml_gp_tpu.equations import HJB as JaxHJB  # noqa: E402
from scasml_gp_tpu.gp import cole_hopf as jch  # noqa: E402

torch.set_num_threads(2)

D = 4
TOL = dict(rtol=2e-4, atol=2e-4)
FLAGS = [(False, False), (True, False), (False, True), (True, True)]


def _rel(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _x(n, seed, d=D):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (n, d + 1)).astype(np.float32)
    x[:, -1] = rng.uniform(0.0, 0.5, n)
    x[:3, -1] = 0.5  # rows on the terminal surface (tau = 0)
    return x


@pytest.fixture(scope="module", params=["mixture", "rbf"])
def carried(request):
    backend = request.param
    eq_j = JaxHJB(n_input=D + 1)
    gp_j = jch.GPHJBColeHopf(eq_j, terminal_backend=backend)
    x_dom, x_bdy = eq_j.generate_data(150, 40, key=jax.random.PRNGKey(3))
    gp_j.GPsolver(x_dom, x_bdy)
    eq_t = port.HJB(n_input=D + 1)
    gp_t = port.GPHJBColeHopf(eq_t, terminal_backend=backend, device="cpu")
    gp_t.state = state_from_numpy(
        {k: np.asarray(v) for k, v in gp_j.state._asdict().items()}, "cpu")
    return gp_j, gp_t, np.array(x_dom), np.array(x_bdy)


@pytest.mark.parametrize("d", [4, 100])
@pytest.mark.parametrize("want_grad,want_ops", FLAGS)
def test_v_block_matches_jax(d, want_grad, want_ops):
    rng = np.random.default_rng(d)
    x = _x(70, seed=1, d=d)
    y = rng.normal(scale=0.6, size=(50, d)).astype(np.float32)
    alpha = rng.normal(scale=0.1, size=50).astype(np.float32)
    s, mbar = np.float32(0.5 * np.sqrt(d)), np.float32(0.3)
    want = jch._v_block(jnp.asarray(x), jnp.asarray(y), jnp.asarray(alpha), s,
                        mbar, 2.0, 0.5, d, want_grad, want_ops)
    got = tch._v_block(torch.from_numpy(x), torch.from_numpy(y),
                       torch.from_numpy(alpha), torch.tensor(s), torch.tensor(mbar),
                       2.0, 0.5, d, want_grad, want_ops)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("want_grad,want_ops", FLAGS)
def test_posterior_on_carried_state_matches_jax(carried, want_grad, want_ops):
    gp_j, gp_t, _, _ = carried
    x = _x(90, seed=2)
    want = gp_j.posterior_u(gp_j.state, jnp.asarray(x), want_grad, want_ops)
    got = gp_t.posterior_u(gp_t.state, torch.from_numpy(x), want_grad, want_ops)
    for name, a, b in zip(want._fields, got, want):
        assert (a is None) == (b is None), name
        if b is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=name)
    assert torch.all(gp_t.residual_u(gp_t.state, torch.from_numpy(x)) == 0.0)


def test_chunked_posterior_matches_one_block(carried):
    _, gp_t, _, _ = carried
    x = torch.from_numpy(_x(50, seed=3))
    whole = gp_t.posterior_u(gp_t.state, x, want_grad=True, want_ops=True)
    gp_t.eval_chunk = 16
    try:
        parts = gp_t.posterior_u(gp_t.state, x, want_grad=True, want_ops=True)
    finally:
        gp_t.eval_chunk = 4096
    for a, b in zip(parts, whole):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_fit_matches_jax(carried):
    """The mixture fit is data-free: same nodes, weights and rates to the
    bit of a float32 cast.  The rbf fit from the JAX centers gives the same
    targets, width, k and mean, and the same surrogate to 2e-4."""
    gp_j, gp_t, x_dom, _ = carried
    st_j = gp_j.state
    if gp_t.terminal_backend == "mixture":
        gp_t.GPsolver(torch.from_numpy(x_dom), None, GN_steps=3)
        for name in ("right_vector", "sol", "gamma"):
            np.testing.assert_array_equal(getattr(gp_t.state, name).numpy(),
                                          np.asarray(getattr(st_j, name)), name)
    else:
        gp_t._fit_rbf(torch.from_numpy(x_dom), torch.from_numpy(np.array(st_j.x_bdy)))
        np.testing.assert_allclose(gp_t.state.sol.numpy(), np.asarray(st_j.sol),
                                   rtol=1e-6)
        np.testing.assert_allclose(gp_t.state.gamma.numpy(), np.asarray(st_j.gamma),
                                   rtol=1e-5)
        x = _x(90, seed=4)
        np.testing.assert_allclose(gp_t.predict(torch.from_numpy(x)).numpy(),
                                   np.asarray(gp_j.predict(jnp.asarray(x))), **TOL)
    assert gp_t.state.x_dom.shape == st_j.x_dom.shape


@pytest.mark.parametrize("d", [4, 100])
def test_constructor_matches_jax(d):
    eq_j, eq_t = JaxHJB(n_input=d + 1), port.HJB(n_input=d + 1)
    for backend in ("auto", "rbf"):
        gp_j = jch.GPHJBColeHopf(eq_j, terminal_backend=backend)
        gp_t = port.GPHJBColeHopf(eq_t, terminal_backend=backend, device="cpu")
        for name in ("k", "sig2", "v_floor", "fit_nugget", "width",
                     "terminal_backend", "eval_chunk"):
            assert getattr(gp_t, name) == getattr(gp_j, name), name
    with pytest.raises(ValueError):
        port.GPHJBColeHopf(port.GradDependentNonlinear(n_input=d + 1),
                           terminal_backend="mixture", device="cpu")


def test_rbf_gp_accuracy_against_the_oracle():
    """A port-trained rbf surrogate (m = 600 centers from the port's own
    generator) against the port's Cole-Hopf oracle: the JAX test's bar,
    rel-L2 < 0.08 at d=4 (tests/test_extra_equations.py)."""
    eq = port.HJB(n_input=D + 1)
    gp = port.GPHJBColeHopf(eq, terminal_backend="rbf", device="cpu")
    x_dom, x_bdy = eq.generate_data(500, 100, torch.Generator().manual_seed(3))
    gp.GPsolver(x_dom, x_bdy)
    x = eq.geometry().sample_domain(torch.Generator().manual_seed(4), 256)
    exact = eq.exact_solution(x, num_mc=16384).numpy()
    assert _rel(gp.predict(x).numpy(), exact) < 0.08


def test_guarded_scasml_repairs_the_coarse_rbf_surrogate():
    """The JAX test's asserts (tests/test_extra_equations.py,
    test_hjb_gp_scasml_pipeline) on the port: a 100-center rbf surrogate is
    coarse (rel-L2 > 0.25), and the guarded full-history ScaSML, which picks
    its schedule from the ladder [(1, 8), (2, 8)], beats 0.6 x GP and the
    plain MLP at the same budget."""
    eq = port.HJB(n_input=D + 1)
    gp = port.GPHJBColeHopf(eq, port.GPConfig(gn_steps=6), terminal_backend="rbf", device="cpu")
    x_dom, x_bdy = eq.generate_data(80, 20, torch.Generator().manual_seed(30))
    gp.GPsolver(x_dom, x_bdy)
    x = eq.geometry().sample_domain(torch.Generator().manual_seed(6), 128)
    exact = eq.exact_solution(x, num_mc=16384).numpy()
    rel_gp = _rel(gp.predict(x).numpy(), exact)
    assert rel_gp > 0.25, rel_gp
    sca = port.ScaSMLFullHistory(eq, gp)
    assert sca.variance_guard
    u = sca.u_solve(2, None, x, M=8).numpy()
    assert np.isfinite(u).all()
    rel_sca = _rel(u, exact)
    rel_mlp = _rel(port.MLPFullHistory(eq, device="cpu").u_solve(2, None, x, M=8).numpy(), exact)
    assert rel_sca < 0.6 * rel_gp, (rel_sca, rel_gp, sca.last_ladder)
    assert rel_sca < rel_mlp, (rel_sca, rel_mlp)
    assert sca.last_lambda >= 0.5


def test_rbf_centres_draw_from_their_own_stream():
    """The rbf centers' default pushes come from a stream of their own
    (cole_hopf.CENTRE_SEED), not from the one a Picard solver takes at its
    default seed 0.  When the two streams were the same, the solver's first
    paths replayed the pushes onto the centers, where the fit is exact, and
    ScaSML's correction of the coarse surrogate came out biased: at d=250
    (stretch_d250's coarse leg, 120 + 30 points) 0.036 rel-L2 against the JAX
    package's 0.012-0.014 on the same points.  Here, on points of that leg
    and 128 test points: the default streams match the JAX package's
    ScaSML within 1.5x, and a shared stream (the centers seeded 0, as the
    solver) is biased."""
    from scasml_gp_tpu.picard import ScaSMLFullHistory as JaxScaSML

    d = 250
    eq = port.HJB(n_input=d + 1)
    xd, xb = eq.generate_data(120, 30, torch.Generator().manual_seed(30), device="cpu")
    x = eq.geometry().sample_domain(torch.Generator().manual_seed(6), 128, device="cpu")
    exact = eq.exact_solution(x, num_mc=8192).numpy()
    rel = {}
    for name, gen in (("default", None), ("shared", torch.Generator().manual_seed(0))):
        gp = port.GPHJBColeHopf(eq, device="cpu", terminal_backend="rbf")
        gp.GPsolver(xd, xb, gen=gen)
        rel[name] = _rel(port.ScaSMLFullHistory(eq, gp).u_solve(2, None, x, M=8).numpy(),
                         exact)
    assert torch.equal(
        gp.state.x_bdy,
        tch.push_to_terminal(torch.cat([xd, xb]), gp.sig2, eq.T,
                             torch.Generator().manual_seed(0)))
    eq_j = JaxHJB(n_input=d + 1)
    gp_j = jch.GPHJBColeHopf(eq_j, terminal_backend="rbf")
    gp_j.GPsolver(jnp.asarray(xd.numpy()), jnp.asarray(xb.numpy()))
    want = _rel(JaxScaSML(eq_j, gp_j).u_solve(2, None, jnp.asarray(x.numpy()), M=8), exact)
    assert rel["default"] < 1.5 * want, (rel, want)
    assert rel["shared"] > 1.5 * rel["default"], rel
