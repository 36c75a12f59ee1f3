"""Port's reaction-semigroup Allen-Cahn surrogate and the shared mixture
evolution (scasml_gp_torch.gp.semigroup) against the JAX package.

The Bernstein panel nodes are numpy in both packages and must be the same
bits.  ``mixture_features`` and the surrogate's posterior (on states the
JAX package trained, carried over with ``state_from_numpy``) agree at
rtol = atol = 2e-4, the posterior's bar.  The rbf fit is compared from the
JAX package's centers, with the JAX width-selection split.  The port's
closed-form derivatives are also held against torch.autograd of its own
posterior mean, at the JAX test's tolerances (tests/test_semigroup.py).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import scasml_gp_torch as port  # noqa: E402
from scasml_gp_torch.gp import semigroup as tsg  # noqa: E402
from scasml_gp_torch.gp.state import state_from_numpy  # noqa: E402
from scasml_gp_tpu.equations import AllenCahn as JaxAC  # noqa: E402
from scasml_gp_tpu.gp import semigroup as jsg  # noqa: E402

torch.set_num_threads(2)

D = 3
TOL = dict(rtol=2e-4, atol=2e-4)
FLAGS = [(False, False), (True, False), (False, True), (True, True)]


def _x(n, seed, d=D, T=0.3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (n, d + 1)).astype(np.float32)
    x[:, -1] = rng.uniform(0.0, T, n)
    return x


@pytest.fixture(scope="module", params=["mixture", "rbf"])
def carried(request):
    backend = request.param
    eq_j = JaxAC(n_input=D + 1)
    gp_j = jsg.GPAllenCahnSemigroup(eq_j, terminal_backend=backend)
    x_dom, x_bdy = eq_j.generate_data(120, 40, key=jax.random.PRNGKey(0))
    gp_j.GPsolver(x_dom, x_bdy)
    gp_t = port.GPAllenCahnSemigroup(port.AllenCahn(n_input=D + 1),
                                     terminal_backend=backend, device="cpu")
    gp_t.state = state_from_numpy(
        {k: np.asarray(v) for k, v in gp_j.state._asdict().items()}, "cpu")
    return gp_j, gp_t, np.array(x_dom)


@pytest.mark.parametrize("k", [1.0, 2.5, 0.5])
def test_bernstein_panel_nodes_are_the_jax_bits(k):
    for a, b in zip(tsg.bernstein_panel_nodes(k), jsg.bernstein_panel_nodes(k)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("d", [3, 100])
@pytest.mark.parametrize("want_grad,want_ops", FLAGS)
def test_mixture_features_match_jax(d, want_grad, want_ops):
    """At d=100 the den^{-d/2} factor spans many decades; both packages form
    it as exp(-(d/2) log den)."""
    t, w = jsg.bernstein_panel_nodes(1.0)
    weights, rates = (w / 2.0).astype(np.float32), (0.2 * t).astype(np.float32)
    x = _x(60, seed=d, d=d)
    want = jsg.mixture_features(jnp.asarray(x), jnp.asarray(weights),
                                jnp.asarray(rates), 2.0, 0.3, d, want_grad, want_ops)
    got = tsg.mixture_features(torch.from_numpy(x), torch.from_numpy(weights),
                               torch.from_numpy(rates), 2.0, 0.3, d, want_grad,
                               want_ops)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("want_grad,want_ops", FLAGS)
def test_posterior_on_carried_state_matches_jax(carried, want_grad, want_ops):
    gp_j, gp_t, _ = carried
    x = _x(80, seed=2)
    want = gp_j.posterior_u(gp_j.state, jnp.asarray(x), want_grad, want_ops)
    got = gp_t.posterior_u(gp_t.state, torch.from_numpy(x), want_grad, want_ops)
    for name, a, b in zip(want._fields, got, want):
        assert (a is None) == (b is None), name
        if b is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=name)
    np.testing.assert_allclose(
        gp_t.compute_PDE_loss(torch.from_numpy(x)).numpy(),
        np.asarray(gp_j.compute_PDE_loss(jnp.asarray(x))), **TOL)


def test_fit_matches_jax(carried, monkeypatch):
    """Mixture: the same weights, rates and gamma bits.  rbf, from the JAX
    centers and the JAX held-out split: the same selected width, mean and
    surrogate."""
    gp_j, gp_t, x_dom = carried
    st_j = gp_j.state
    if gp_t.terminal_backend == "mixture":
        gp_t.GPsolver(torch.from_numpy(x_dom), None)
        for name in ("right_vector", "sol", "gamma"):
            np.testing.assert_array_equal(getattr(gp_t.state, name).numpy(),
                                          np.asarray(getattr(st_j, name)), name)
        return
    m = st_j.x_bdy.shape[0]
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(0), m))
    monkeypatch.setattr(tsg, "_width_split",
                        lambda m_, seed, device: torch.from_numpy(perm))
    gp_t._fit_rbf(torch.from_numpy(x_dom), torch.from_numpy(np.array(st_j.x_bdy)))
    np.testing.assert_allclose(gp_t.state.gamma.numpy(), np.asarray(st_j.gamma),
                               rtol=1e-5)
    np.testing.assert_allclose(gp_t.state.sol.numpy(), np.asarray(st_j.sol),
                               rtol=1e-6)
    x = _x(80, seed=3)
    np.testing.assert_allclose(gp_t.predict(torch.from_numpy(x)).numpy(),
                               np.asarray(gp_j.predict(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("backend", ["mixture", "rbf"])
def test_port_fit_derivatives_residual_and_terminal(backend):
    """On a port-trained surrogate: grad, dt, div and lap equal autograd of
    u; the Allen-Cahn residual is exactly -u^3; u(x, T) = g(x)."""
    eq = port.AllenCahn(n_input=D + 1)
    gp = port.GPAllenCahnSemigroup(eq, terminal_backend=backend, device="cpu")
    x_dom, x_bdy = eq.generate_data(120, 40, torch.Generator().manual_seed(0))
    gp.GPsolver(x_dom, x_bdy)
    x = torch.from_numpy(_x(16, seed=5)).requires_grad_(True)
    out = gp.posterior_u(gp.state, x, want_grad=True, want_ops=True)
    (g,) = torch.autograd.grad(gp.predict(x).sum(), x, create_graph=True)
    lap = sum(torch.autograd.grad(g[:, i].sum(), x, retain_graph=True)[0][:, i]
              for i in range(D))
    det = lambda t: t.detach().numpy()  # noqa: E731
    np.testing.assert_allclose(det(out.grad), det(g), rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(det(out.dt_u), det(g[:, -1]), rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(det(out.div_u), det(g[:, :-1].sum(1)), rtol=2e-3,
                               atol=2e-5)
    np.testing.assert_allclose(det(out.lap_u), det(lap), rtol=5e-3, atol=5e-5)

    x = torch.from_numpy(_x(128, seed=6))
    u = gp.predict(x)[:, 0]
    np.testing.assert_allclose(gp.compute_PDE_loss(x)[:, 0].numpy(),
                               (-(u**3)).numpy(), rtol=1e-3, atol=1e-6)
    x[:, -1] = eq.T
    err = (gp.predict(x) - eq.g(x)).abs().max()
    assert err < (1e-4 if backend == "mixture" else 2e-2), err
    if backend == "rbf":
        unit = gp._width_unit
        assert 0.4 * unit < float(gp.state.gamma[0]) < 1.1 * unit


def test_scasml_on_the_mixture_does_not_degrade_it():
    """Against the port's deep-MC oracle (tests/test_semigroup.py's bar):
    the mixture surrogate is within a few percent, and ScaSML on it does not
    degrade it beyond the rollout's noise."""
    from scasml_gp_torch.harness.metrics import mc_reference_solution

    eq = port.AllenCahn(n_input=D + 1)
    gp = port.GPAllenCahnSemigroup(eq, device="cpu")
    x_dom, x_bdy = eq.generate_data(64, 16, torch.Generator().manual_seed(0))
    gp.GPsolver(x_dom, x_bdy)
    x = torch.from_numpy(_x(128, seed=7))
    ref = mc_reference_solution(eq, x, seed=11).ravel()
    rel = lambda u: np.linalg.norm(u.numpy().ravel() - ref) / np.linalg.norm(ref)  # noqa: E731
    rel_gp = rel(gp.predict(x))
    rel_sc = rel(port.ScaSMLFullHistory(eq, gp).u_solve(2, None, x, M=3))
    assert rel_gp < 0.05, rel_gp
    assert rel_sc < max(2.0 * rel_gp, 0.08), (rel_sc, rel_gp)
