"""The marginal-likelihood fit's restarts as one batched program
(scasml_gp_torch.gp.marginal, gram, kernels, solver) against the JAX
package's vmapped functions, at D=4 on 40 + 12 points (the
tests/test_torch_marginal.py problem).

The same numpy inputs go through both packages.  On the CPU the fit's Adam
steps run eagerly; here an eager stand-in for the CUDA graph capture holds
its bookkeeping (tests/test_torch_cuda.py holds the graphed rounds bitwise
to eager ones on the card).
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import scasml_gp_torch as port  # noqa: E402
from scasml_gp_torch.gp import marginal as pm  # noqa: E402
from scasml_gp_torch.gp.gram import gram_matrix, logdet_quad  # noqa: E402
from scasml_gp_tpu.config import GPConfig as JaxGPConfig  # noqa: E402
from scasml_gp_tpu.equations import GradDependentNonlinear as JaxEq  # noqa: E402
from scasml_gp_tpu.gp import GPGradDependentNonlinear as JaxGP  # noqa: E402
from scasml_gp_tpu.gp import gram as jgram  # noqa: E402
from scasml_gp_tpu.gp import marginal as jm  # noqa: E402

torch.set_num_threads(2)

D, N, NB = 4, 40, 12
PHI = 4 * N + NB
# (gamma_scale, time_scale, ridge_scale, nugget) of three restarts
PARAMS = [(1.0, 1.0, 0.0, 1e-2), (1.3, 0.7, 5.0, 3e-2), (1.0, 1.0, 10.0, 1e-2)]
# equilibrated M indefinite in float32 at this kernel: the probe fails and
# the 1e-3 jitter repairs it
JITTERED = (0.03, 1.0, 0.0, 1e-8)


@pytest.fixture(scope="module")
def data():
    eq_j = JaxEq(n_input=D + 1)
    x_dom, x_bdy = eq_j.generate_data(N, NB, key=jax.random.PRNGKey(3))
    return eq_j, np.array(x_dom), np.array(x_bdy)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _thetas(params):
    return np.stack([jm._params_to_theta(*p) for p in params])


def _rel(a, b):
    """Per restart, the largest distance of a from b over b's largest
    entry (the bar of tests/test_torch_gp.py)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max(axis=-1) / np.abs(b).max(axis=-1)


def test_batched_gram_is_bitwise_per_restart_and_matches_jax_vmap(data):
    """gamma (R, 3) gives R Grams, each bitwise the Gram of its own gamma,
    and within 2e-4 of jax.vmap(gram_matrix) scaled by the largest entry."""
    eq_j, x_dom, x_bdy = data
    sigma = float(eq_j.sigma())
    theta = _thetas(PARAMS)
    gammas = pm._gamma_of(_t(theta), sigma, D)
    assert gammas.shape == (3, 3)
    K = gram_matrix(_t(x_dom), _t(x_bdy), gammas, D)
    assert K.shape == (3, PHI, PHI)
    for r in range(3):
        assert torch.equal(K[r], gram_matrix(_t(x_dom), _t(x_bdy), gammas[r], D)), r
    K_j = np.asarray(jax.vmap(lambda g: jgram.gram_matrix(x_dom, x_bdy, g, D))(
        jax.vmap(lambda t: jm._gamma_of(t, sigma, D))(jnp.asarray(theta))))
    for r in range(3):
        scale = np.abs(K_j[r]).max()
        np.testing.assert_allclose(K[r].numpy() / scale, K_j[r] / scale,
                                   rtol=2e-4, atol=2e-4)


def _jax_value_and_grad(eq_j, x_dom, x_bdy, theta, b):
    def nlml(t, b_i):
        gamma = jm._gamma_of(t, eq_j.sigma(), D)
        K = jgram.gram_matrix(x_dom, x_bdy, gamma, D)
        logdet, quad = jgram.logdet_quad(K, jm._theta_to_params(t)[3], b_i)
        return 0.5 * (logdet + quad)
    val, g = jax.vmap(jax.value_and_grad(nlml))(jnp.asarray(theta), jnp.asarray(b))
    return np.asarray(val), np.asarray(g)


def _port_value_and_grad(sigma, x_dom, x_bdy, theta, b):
    th = _t(theta).requires_grad_(True)
    val = pm._nlml(th, _t(b), _t(x_dom), _t(x_bdy), sigma, D)
    (g,) = torch.autograd.grad(val.sum(), th)
    return val.detach().numpy(), g.numpy()


def _probe_info(K, nugget):
    """cholesky_ex's info for each equilibrated M of logdet_quad."""
    K = 0.5 * (K + K.mT)
    d = torch.clamp_min(torch.diagonal(K, dim1=-2, dim2=-1), 1e-12) + nugget[:, None]
    M = torch.rsqrt(d)[:, :, None] * (K + nugget[:, None, None] * torch.eye(K.shape[-1])) \
        * torch.rsqrt(d)[:, None, :]
    return [int(torch.linalg.cholesky_ex(m)[1]) for m in M]


def test_batched_nlml_and_gradient_in_theta_match_jax_vmap(data):
    """The batched NLML (Gram, logdet_quad) and its gradient in theta
    against jax.vmap of the JAX package's, within 1e-4 relative, with a
    restart whose M needs the 1e-3 jitter and one whose kernel is NaN
    (gamma_scale = e^100 overflows) in the same batch: the NaN stays in its
    row, and every other restart's value and gradient equal its
    single-restart call.  (The jittered restart is held to the JAX package
    on a shared K in the next test: its quad, conditioned ~1e5, moves by
    1e-4 between the two packages' float32 Grams.)"""
    eq_j, x_dom, x_bdy = data
    sigma = float(eq_j.sigma())
    nan_theta = np.array([100.0, 0.0, -14.0, np.log(1e-2)], np.float32)
    theta = np.concatenate([_thetas(PARAMS[:2] + [JITTERED]), nan_theta[None]])
    b = np.array(jax.random.normal(jax.random.PRNGKey(1), (4, PHI)))
    th = _t(theta)
    K = gram_matrix(_t(x_dom), _t(x_bdy), pm._gamma_of(th, sigma, D), D)
    info = _probe_info(K[:3], pm._theta_to_params(th)[3][:3])
    assert info[0] == info[1] == 0 and info[2] != 0

    val, g = _port_value_and_grad(sigma, x_dom, x_bdy, theta, b)
    val_j, g_j = _jax_value_and_grad(eq_j, x_dom, x_bdy, theta[:2], b[:2])
    assert np.all(np.isfinite(val[:3])) and np.all(np.isfinite(g[:3]))
    assert not np.isfinite(val[3]) and not np.all(np.isfinite(g[3]))
    np.testing.assert_allclose(val[:2], val_j, rtol=1e-4)
    for r in range(3):
        if r < 2:
            np.testing.assert_allclose(g[r], g_j[r], rtol=1e-4,
                                       atol=1e-4 * np.abs(g_j[r]).max())
        v1, g1 = _port_value_and_grad(sigma, x_dom, x_bdy, theta[r], b[r])
        np.testing.assert_allclose(val[r], v1, rtol=1e-6)
        # the jittered restart's backward, conditioned ~1e5, carries the
        # batched triangular solves' summation order to 1e-4 of its largest
        # entry
        bar = 1e-5 if r < 2 else 1e-3
        np.testing.assert_allclose(g[r], g1, rtol=bar, atol=bar * np.abs(g1).max())


def _unit_diag_indefinite(n, lam_min=-5e-4):
    """A unit-diagonal K whose smallest eigenvalue is lam_min < 0: the
    probe factorization fails and the 1e-3 jitter repairs it."""
    c = -(1.0 - lam_min) / (n - 1)
    return np.eye(n) * (1.0 - c) + c * np.ones((n, n))


def test_batched_logdet_quad_and_gradient_match_jax_vmap(data):
    """logdet_quad on a batch K (R, phi, phi), nugget (R,), b (R, phi)
    against jax.vmap of the JAX package's: value and gradient in K, nugget
    and b within 1e-4 relative.  The batch: a Gram, a matrix whose probe
    fails (the 1e-3 jitter), and a Gram with a NaN entry; the NaN reaches
    no other restart's value or gradient, each of which equals the
    single-matrix call."""
    eq_j, x_dom, x_bdy = data
    sigma = float(eq_j.sigma())
    gamma = pm._gamma_of(_t(_thetas(PARAMS[:1])), sigma, D)[0]
    Kg = gram_matrix(_t(x_dom), _t(x_bdy), gamma, D).numpy()
    K_nan = Kg.copy()
    K_nan[3, 5] = np.nan
    K = np.stack([Kg, _unit_diag_indefinite(PHI).astype(np.float32), K_nan])
    nugget = np.array([1e-2, 0.0, 1e-2], np.float32)
    b = np.array(jax.random.normal(jax.random.PRNGKey(4), (3, PHI)))
    assert _probe_info(_t(K[:2]), _t(nugget[:2])) == [0, _probe_info(
        _t(K[1:2]), _t(nugget[1:2]))[0]] and _probe_info(_t(K[1:2]), _t(nugget[1:2]))[0] != 0

    def port(K, nugget, b):
        args = [_t(a).requires_grad_(True) for a in (K, nugget, b)]
        ld, quad = logdet_quad(*args)
        grads = torch.autograd.grad((ld + quad).sum(), args)
        return (np.stack([ld.detach().numpy(), quad.detach().numpy()], -1),
                [gr.numpy() for gr in grads])

    def jax_one(K, nugget, b):
        ld, quad = jgram.logdet_quad(K, nugget, b)
        return ld + quad, jnp.stack([ld, quad])

    val, grads = port(K, nugget, b)
    (_, val_j), grads_j = jax.vmap(jax.value_and_grad(jax_one, argnums=(0, 1, 2),
                                                      has_aux=True))(
        jnp.asarray(K), jnp.asarray(nugget), jnp.asarray(b))
    val_j, grads_j = np.asarray(val_j), [np.asarray(gr) for gr in grads_j]
    assert np.all(np.isfinite(val[:2])) and not np.all(np.isfinite(val[2]))
    np.testing.assert_allclose(val[:2], val_j[:2], rtol=1e-4)
    for gr, gr_j in zip(grads, grads_j):
        assert np.all(np.isfinite(gr[:2]))
        for r in range(2):
            np.testing.assert_allclose(gr[r], gr_j[r], rtol=1e-4,
                                       atol=1e-4 * np.abs(gr_j[r]).max())
    for r in range(2):
        v1, g1 = port(K[r:r + 1], nugget[r:r + 1], b[r:r + 1])
        np.testing.assert_array_equal(val[r], v1[0])
        for gr, gr1 in zip(grads, g1):
            np.testing.assert_allclose(gr[r], gr1[0], rtol=1e-6,
                                       atol=1e-6 * np.abs(gr1[0]).max())


@pytest.fixture(scope="module")
def trains(data):
    """The batched Newton train on three thetas in both packages from the
    JAX trainer's sol0, and the port's per-restart trains."""
    eq_j, x_dom, x_bdy = data
    steps = 8
    cfg = port.GPConfig(gn_steps=steps)
    sigma = float(eq_j.sigma())
    theta = _thetas(PARAMS)
    gammas = jax.vmap(lambda t: jm._gamma_of(t, sigma, D))(jnp.asarray(theta))
    nuggets = jnp.asarray([p[3] for p in PARAMS], jnp.float32)

    gp_j = JaxGP(eq_j, JaxGPConfig(gn_steps=steps))
    bdy_g = eq_j.g(jnp.asarray(x_bdy))[:, 0].astype(jnp.float32)
    rhs = gp_j.form.rhs_f(jnp.asarray(x_dom)).astype(jnp.float32)
    want = jax.vmap(lambda g, n: gp_j._train_jit(
        jnp.asarray(x_dom), jnp.asarray(x_bdy), bdy_g, rhs, g, n, steps=steps,
        damping=cfg.damping, grad_tol=cfg.grad_tol, init_scale=cfg.init_scale))(
        gammas, nuggets)

    eq = port.GradDependentNonlinear(n_input=D + 1)
    gp = port.GPGradDependentNonlinear(eq, cfg, device="cpu")
    sol0 = _t(jax.random.normal(jax.random.PRNGKey(0), (3 * N,)) * cfg.init_scale)
    args = (_t(x_dom), _t(x_bdy), _t(bdy_g), _t(rhs))
    got = gp._train(*args, _t(gammas), _t(nuggets), steps, cfg.damping, cfg.grad_tol,
                    sol0)
    single = [gp._train(*args, _t(gammas[r]), _t(nuggets[r]), steps, cfg.damping,
                        cfg.grad_tol, sol0) for r in range(3)]
    return want, got, single


@pytest.mark.parametrize("field,bar", [("sol", 2e-3), ("right_vector", 1e-3),
                                       ("loss_history", 1e-3)])
def test_batched_train_matches_jax_vmap(trains, field, bar):
    """jax.vmap(_train_jit) from JAX's sol0 against the port's batched
    train, per restart: the weights and the loss history within 1e-3
    relative.  The latents sol within 2e-3: on this problem the two
    packages' converged single trains already stand 0.9e-3 to 1.3e-3 apart
    in sol (the same at 8, 12 and 20 steps, with the losses within 1e-6), a
    float32 sensitivity of the minimiser and not the batch, whose restarts
    are bitwise the port's single trains (the next test)."""
    want, got, _ = trains
    a, b = getattr(got, field).numpy(), np.asarray(getattr(want, field))
    assert a.shape == b.shape == (3,) + a.shape[1:]
    assert np.all(np.isfinite(a))
    assert np.all(_rel(a, b) < bar), _rel(a, b)


@pytest.mark.parametrize("field", ["sol", "right_vector", "loss_history"])
def test_batched_train_matches_per_restart_trains(trains, field):
    """Each restart of the batched train against the port's own train at
    that restart's kernel: within 1e-5 relative (bitwise on the CPU, where
    the batched train's factorizations, solves and matrix-vector products
    run one restart at a time, gram.per_matrix)."""
    _, got, single = trains
    a = getattr(got, field).numpy()
    b = np.stack([getattr(s, field).numpy() for s in single])
    assert np.all(_rel(a, b) < 1e-5), _rel(a, b)


class StandIn:
    """An eager stand-in for the CUDA graph capture of the fit's Adam step:
    'capturing' records the step without running it, as a capture leaves
    the buffers untouched; a replay runs it eagerly."""

    def __init__(self, run, what):
        assert "Adam" in what
        self.run, self.replays, self.closed = run, 0, False

    def replay(self):
        assert not self.closed
        self.run()
        self.replays += 1

    def close(self):
        self.closed = True


def _fit(eq, x_dom, x_bdy, **kw):
    return pm.fit_gp_marginal_likelihood(
        port.GPGradDependentNonlinear, eq, _t(x_dom), _t(x_bdy),
        base=port.GPConfig(gn_steps=4), outer_rounds=3, inner_steps=5,
        init_ridge_scales=(0.0, 3.0, 10.0), **kw)


def test_captured_rounds_replay_one_graph_and_equal_eager(data, monkeypatch):
    """Through the capture path (a stand-in here): round 1 eager, one
    capture per fit call, every later Adam step a replay with that round's
    theta, b and fresh moments copied in; the history and the table are
    bitwise the eager batched fit's, and the graph is freed."""
    _, x_dom, x_bdy = data
    eq = port.GradDependentNonlinear(n_input=D + 1)
    scores = iter(range(1000))
    monkeypatch.setattr(pm, "scasml_judge",
                        lambda *a, **kw: lambda gamma, nugget: float(next(scores)))
    assert pm.eager_reason(torch.device("cpu")) == "not a CUDA device"
    want = _fit(eq, x_dom, x_bdy)
    scores = iter(range(1000))

    made = []

    def capture(run, what):
        made.append(StandIn(run, what))
        return made[-1]

    monkeypatch.setattr(pm, "_capture", capture)
    monkeypatch.setattr(pm, "eager_reason", lambda device: None)
    for fits in (1, 2):
        scores = iter(range(1000))
        got = _fit(eq, x_dom, x_bdy)
        assert len(made) == fits and made[-1].replays == 5 * (3 - 1) and made[-1].closed
        assert got.history.shape == (3, 3)
        np.testing.assert_array_equal(got.history, want.history)
        assert [dataclasses.asdict(c) for c, _, _ in got.table] == \
            [dataclasses.asdict(c) for c, _, _ in want.table]
        assert [n for _, n, _ in got.table][1:] == [n for _, n, _ in want.table][1:]


def test_eager_switch_names_its_reason():
    with pm._eager():
        assert pm.eager_reason(torch.device("cuda", 0)) == "eager on request (_eager)"
    assert pm.eager_reason(torch.device("cuda", 0)) is None


def test_judge_rollouts_stay_eager_where_solvers_are_graphed(data, monkeypatch):
    """The ScaSML judge of the tune and of the fit scores each candidate's
    own trained state with one call per validation set, so it runs its
    rollouts eagerly even where a solver would replay graphs: with every
    solver set to graph, no judge rollout reaches a graph cache, and the
    scores equal the eager ones."""
    from scasml_gp_torch.gp.tuning import scasml_judge
    from scasml_gp_torch.picard import graphs
    from scasml_gp_torch.picard.mlp import _PicardBase

    _, x_dom, x_bdy = data
    eq = port.GradDependentNonlinear(n_input=D + 1)
    base = port.GPConfig(gn_steps=4)
    gamma = torch.tensor(port.GPGradDependentNonlinear(eq, base, device="cpu").gamma)

    def score():
        return scasml_judge(port.GPGradDependentNonlinear, eq, base, _t(x_dom), _t(x_bdy),
                            4)(gamma, base.nugget)

    want = score()

    def no_graphs(self, *a, **kw):
        raise AssertionError("a judge rollout went to the graph cache")

    monkeypatch.setattr(graphs.GraphCache, "__call__", no_graphs)
    monkeypatch.setattr(graphs, "eager_reason", lambda *a, **kw: None)
    monkeypatch.setattr(_PicardBase, "eager_reason", lambda self: (
        "eager on request (_eager)" if self._eager_only else None))
    assert score() == want
