"""Port's marginal-likelihood fit (scasml_gp_torch.gp.marginal and
gram.logdet_quad) and the runner's --fit-ml against the JAX package, at D=4
on 40 + 12 points (the tests/test_marginal.py problem).

The same numpy inputs go through both packages.  Where a Newton train runs,
the port starts from the JAX trainer's own initial point
(normal(PRNGKey(0)) x init_scale), so the two fits see the same latents up
to float32 round-off.  Judge scores are Monte-Carlo estimates from different
generators on the two sides and agree within SCORE_REL, the bar of
tests/test_torch_tuning.py.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import scasml_gp_torch as port  # noqa: E402
from scasml_gp_torch.gp import marginal as pm  # noqa: E402
from scasml_gp_torch.gp.gram import logdet_quad  # noqa: E402
from scasml_gp_torch.harness import runner  # noqa: E402
from scasml_gp_tpu.config import GPConfig as JaxGPConfig  # noqa: E402
from scasml_gp_tpu.equations import GradDependentNonlinear as JaxEq  # noqa: E402
from scasml_gp_tpu.gp import GPGradDependentNonlinear as JaxGP  # noqa: E402
from scasml_gp_tpu.gp import gram as jgram  # noqa: E402
from scasml_gp_tpu.gp import marginal as jm  # noqa: E402

torch.set_num_threads(2)

D, N, NB = 4, 40, 12
SCORE_REL = 0.35
# (gamma_scale, time_scale, ridge_scale, nugget)
PARAMS = [(1.0, 1.0, 0.0, 1e-2), (1.3, 0.7, 5.0, 3e-2), (0.1, 2.0, 30.0, 1e-4)]


@pytest.fixture(scope="module")
def data():
    eq_j = JaxEq(n_input=D + 1)
    x_dom, x_bdy = eq_j.generate_data(N, NB, key=jax.random.PRNGKey(3))
    return eq_j, np.array(x_dom), np.array(x_bdy)


@pytest.fixture
def jax_sol0(monkeypatch):
    """The port's Newton trains start where the JAX package's do."""
    orig = port.GP._train

    def train(self, x_dom, x_bdy, bdy_g, rhs, gamma, nugget, steps, damping,
              grad_tol, sol0=None):
        if sol0 is None:
            n3 = 3 * x_dom.shape[0]
            sol0 = torch.from_numpy(np.array(
                jax.random.normal(jax.random.PRNGKey(0), (n3,))
                * self.config.init_scale, np.float32))
        return orig(self, x_dom, x_bdy, bdy_g, rhs, gamma, nugget, steps,
                    damping, grad_tol, sol0)

    monkeypatch.setattr(port.GP, "_train", train)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("params", PARAMS)
def test_theta_maps_match_jax(params):
    theta = pm._params_to_theta(*params)
    np.testing.assert_array_equal(theta, jm._params_to_theta(*params))
    got = [float(v) for v in pm._theta_to_params(_t(theta))]
    want = [float(v) for v in jm._theta_to_params(jnp.asarray(theta))]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, params, rtol=1e-4, atol=1e-6)
    sigma = float(port.GradDependentNonlinear(n_input=D + 1).sigma())
    np.testing.assert_allclose(pm._gamma_of(_t(theta), sigma, D).numpy(),
                               np.asarray(jm._gamma_of(jnp.asarray(theta), sigma, D)),
                               rtol=1e-6)


def _unit_diag_indefinite(n=20, lam_min=-5e-4):
    """A unit-diagonal K whose smallest eigenvalue is lam_min < 0: the
    probe factorization fails and the 1e-3 jitter repairs it."""
    c = -(1.0 - lam_min) / (n - 1)
    return np.eye(n) * (1.0 - c) + c * np.ones((n, n))


@pytest.mark.parametrize("case", ["gram", "gram_ridge", "jittered"])
def test_logdet_quad_matches_jax_and_float64(data, case):
    eq_j, x_dom, x_bdy = data
    if case == "jittered":
        K, nugget = _unit_diag_indefinite().astype(np.float32), 0.0
    else:
        params = PARAMS[0] if case == "gram" else PARAMS[1]
        gamma = jm._gamma_of(jnp.asarray(jm._params_to_theta(*params)), eq_j.sigma(), D)
        K, nugget = np.array(jgram.gram_matrix(x_dom, x_bdy, gamma, D)), params[3]
    b = np.random.default_rng(0).standard_normal(K.shape[0]).astype(np.float32)
    ld, quad = (float(v) for v in logdet_quad(_t(K), nugget, _t(b)))
    ld_j, quad_j = (float(v) for v in jgram.logdet_quad(
        jnp.asarray(K), jnp.float32(nugget), jnp.asarray(b)))
    np.testing.assert_allclose([ld, quad], [ld_j, quad_j], rtol=1e-4)
    if case == "jittered":
        # the JAX package's answer: K + 1e-3 I
        Kp = K.astype(np.float64) + 1e-3 * np.eye(K.shape[0])
    else:
        Kp = K.astype(np.float64)
        Kp = 0.5 * (Kp + Kp.T) + nugget * np.eye(Kp.shape[0])
    sign, ld_ref = np.linalg.slogdet(Kp)
    assert sign > 0
    quad_ref = b.astype(np.float64) @ np.linalg.solve(Kp, b.astype(np.float64))
    np.testing.assert_allclose([ld, quad], [ld_ref, quad_ref], rtol=2e-3)


def _jax_nlml(eq_j, x_dom, x_bdy, b):
    def nlml(theta):
        gamma = jm._gamma_of(theta, eq_j.sigma(), D)
        K = jgram.gram_matrix(x_dom, x_bdy, gamma, D)
        logdet, quad = jgram.logdet_quad(K, jm._theta_to_params(theta)[3], b)
        return 0.5 * (logdet + quad)
    return nlml


@pytest.mark.parametrize("params", [(1.0, 1.0, 1.0, 2e-2), PARAMS[1]])
def test_nlml_gradient_matches_jax_and_finite_differences(data, params):
    eq_j, x_dom, x_bdy = data
    b = np.array(jax.random.normal(jax.random.PRNGKey(1), (4 * N + NB,)))
    theta = jm._params_to_theta(*params)
    want = np.asarray(jax.grad(_jax_nlml(eq_j, jnp.asarray(x_dom),
                                         jnp.asarray(x_bdy), jnp.asarray(b)))(
        jnp.asarray(theta)))

    sigma = float(eq_j.sigma())
    xd, xb, bt = _t(x_dom), _t(x_bdy), _t(b)
    th = _t(theta).requires_grad_(True)
    pm._nlml(th, bt, xd, xb, sigma, D).backward()
    got = th.grad.numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
    for i in range(4):
        e = torch.zeros(4)
        e[i] = 1e-3
        with torch.no_grad():
            fd = (float(pm._nlml(_t(theta) + e, bt, xd, xb, sigma, D))
                  - float(pm._nlml(_t(theta) - e, bt, xd, xb, sigma, D))) / 2e-3
        assert np.isclose(got[i], fd, rtol=5e-2, atol=5e-2), (i, got[i], fd)


@pytest.mark.parametrize("R", [1, 3])
def test_adam_steps_match_optax(data, R):
    """12 Adam steps of the MAP objective from the same theta0 with the
    same fixed b, on a batch of R restarts: the port's batched Adam
    (optax's form on the batch) against vmapped optax.adam over the JAX
    package's objective, nugget frozen."""
    eq_j, x_dom, x_bdy = data
    steps, lr, prior = 12, 0.08, 2.0
    b = np.array(jax.random.normal(jax.random.PRNGKey(2), (R, 4 * N + NB)))
    theta0 = np.stack([jm._params_to_theta(1.0, 1.0, 3.0, 1e-2),
                       jm._params_to_theta(1.3, 0.7, 5.0, 3e-2),
                       jm._params_to_theta(0.5, 1.0, 10.0, 1e-2)][:R])
    mask = np.array([1.0, 1.0, 1.0, 0.0], np.float32)

    def objective(theta, b_i, anchor):
        nlml_j = _jax_nlml(eq_j, jnp.asarray(x_dom), jnp.asarray(x_bdy), b_i)
        return nlml_j(theta) + 0.5 * prior * jnp.sum((theta - anchor) ** 2)

    opt = optax.adam(lr)

    def one(theta, state, b_i, anchor):
        g = jax.grad(objective)(theta, b_i, anchor)
        g = jnp.where(jnp.isfinite(g), g, 0.0) * mask
        updates, state = opt.update(g, state, theta)
        return optax.apply_updates(theta, updates), state

    theta = jnp.asarray(theta0)
    state = jax.vmap(opt.init)(theta)
    for _ in range(steps):
        theta, state = jax.vmap(one)(theta, state, jnp.asarray(b), jnp.asarray(theta0))

    sigma = float(eq_j.sigma())
    xd, xb = _t(x_dom), _t(x_bdy)
    adam = pm._MapAdam(lambda t, bb: pm._nlml(t, bb, xd, xb, sigma, D), _t(theta0),
                       steps, lr, prior, _t(mask), graphed=False)
    got = adam(_t(theta0), _t(b))
    assert got.shape == (R, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(theta), rtol=1e-4, atol=1e-6)
    assert torch.equal(got[:, 3], _t(theta0)[:, 3])  # the frozen nugget


def _configs_close(a, b, rtol):
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], float):
            assert np.isclose(fa[k], fb[k], rtol=rtol, atol=1e-5), (k, fa[k], fb[k])
        else:
            assert fa[k] == fb[k], k


def test_fit_table_matches_jax(data, jax_sol0):
    """The whole fit with 4 ridge restarts and one seed config (5 restarts,
    so the jittered sixth joins, as in the runner's call): the table has the
    JAX fit's rows, the same anchors, the same descended configs within
    1e-3, finite NLML history and scores, scores within SCORE_REL of the JAX
    package's, and the shipped config scores no worse than the seed."""
    eq_j, x_dom, x_bdy = data
    kw = dict(outer_rounds=2, inner_steps=12, gn_steps=8)
    seed_j = JaxGPConfig(gn_steps=8, ridge_scale=10.0, gamma_scale=0.3)
    want = jm.fit_gp_marginal_likelihood(
        JaxGP, eq_j, jnp.asarray(x_dom), jnp.asarray(x_bdy),
        base=JaxGPConfig(gn_steps=8), seed_configs=(seed_j,), **kw)

    eq = port.GradDependentNonlinear(n_input=D + 1)
    seed_t = port.GPConfig(gn_steps=8, ridge_scale=10.0, gamma_scale=0.3)
    got = pm.fit_gp_marginal_likelihood(
        port.GPGradDependentNonlinear, eq, _t(x_dom), _t(x_bdy),
        base=port.GPConfig(gn_steps=8), seed_configs=(seed_t,), **kw)

    assert len(got.table) == len(want.table) == 1 + 1 + 6
    assert got.history.shape == want.history.shape == (2, 6)
    assert np.all(np.isfinite(got.history))
    np.testing.assert_allclose(got.history, want.history, rtol=1e-3)
    assert dataclasses.asdict(got.table[1][0]) == dataclasses.asdict(seed_j)
    for (cfg_t, nlml_t, s_t), (cfg_j, nlml_j, s_j) in zip(got.table, want.table):
        _configs_close(cfg_t, cfg_j, rtol=1e-3)
        assert np.isnan(nlml_t) == np.isnan(nlml_j)
        assert np.isfinite(s_t) and s_t > 0
        assert abs(s_t / s_j - 1.0) < SCORE_REL, (cfg_t, s_t, s_j)
    shipped = [s for cfg, _, s in got.table if cfg == got.config][0]
    assert shipped <= got.table[1][2]
    assert got.config in [cfg for cfg, _, _ in got.table]


def test_fit_ml_cli_runs_on_the_cpu(tmp_path, capsys):
    """--fit-ml through runner.main at a tiny size: the grid, the fit and
    the run, with the metrics.json of SimpleUniform."""
    out = runner.main([
        "--dim", "3", "--num-domain", "40", "--num-boundary", "12",
        "--test-domain", "40", "--test-boundary", "8", "--device", "cpu",
        "--variant", "full_history", "--M", "2", "--fit-ml", "--no-plots",
        "--save-path", str(tmp_path)])
    assert "ML-fitted GP config" in capsys.readouterr().err
    path = tmp_path / "GradDependentNonlinear" / "3d" / "full_history" / "SimpleUniform"
    with open(path / "metrics.json") as fh:
        m = json.load(fh)
    assert m["metrics"]["SCaSML"]["rel_L2"] == out["metrics"]["SCaSML"]["rel_L2"]
    assert all(np.isfinite(m["metrics"][s]["rel_L2"]) for s in ("GP", "MLP", "SCaSML"))
    assert os.path.exists(path / "SimpleUniform.log")


def test_fitted_config_warns_above_d20_and_seeds_from_the_grid(monkeypatch, capsys):
    """fitted_config runs the 4-candidate ridge grid on the harness's
    training points, seeds the fit with its winner, and warns at d > 20."""
    seen = {}

    def fake_tune(gp_cls, eq, x_dom, x_bdy, base, **kw):
        seen["tune"] = (x_dom, kw)
        return port.gp.tuning.TuneResult(
            config=dataclasses.replace(base, ridge_scale=30.0), score=0.0, table=[])

    def fake_fit(gp_cls, eq, x_dom, x_bdy, base, seed_configs):
        seen["fit"] = (x_dom, seed_configs)
        return pm.MarginalFitResult(config=seed_configs[0], nlml=0.0,
                                    table=[], history=np.zeros((1, 1)))

    monkeypatch.setattr(runner, "tune_gp", fake_tune)
    monkeypatch.setattr(runner, "fit_gp_marginal_likelihood", fake_fit)
    cfg = port.RunConfig(dim=21, num_domain=30, num_boundary=8, seed=5)
    out, _ = runner.fitted_config(cfg, "cpu")
    assert "warning: --fit-ml at d > 20" in capsys.readouterr().err
    assert seen["tune"][1]["ridge_scales"] == (0.0, 10.0, 30.0, 100.0)
    assert "gamma_scales" not in seen["tune"][1]
    assert torch.equal(seen["tune"][0], seen["fit"][0])
    assert out.gp.ridge_scale == 30.0 and seen["fit"][1][0].ridge_scale == 30.0
    runner.fitted_config(dataclasses.replace(cfg, dim=20), "cpu")
    assert "warning" not in capsys.readouterr().err


def test_fitted_config_posterior_calls(monkeypatch):
    """The posterior calls (on a GPU, one kernel launch each) of --fit-ml,
    pinned for chip_smoke.py phase 7: each judged candidate costs 3
    rollouts of g_breve 2, f_breve 1 and leaf 2; the grid judges 4
    candidates and the fit its 8 table rows; the fit's rounds make none."""
    import functools

    calls, parts = {}, {}
    orig = port.GP.posterior_u

    def counting(self, params, x_t, want_grad=False, want_ops=False):
        calls[(want_grad, want_ops)] = calls.get((want_grad, want_ops), 0) + 1
        return orig(self, params, x_t, want_grad, want_ops)

    def counted(part, fn):
        def wrapper(*a, **kw):
            calls.clear()
            out = fn(*a, **kw)
            parts[part] = dict(calls)
            return out
        return wrapper

    monkeypatch.setattr(port.GP, "posterior_u", counting)
    monkeypatch.setattr(runner, "tune_gp", counted("grid", runner.tune_gp))
    monkeypatch.setattr(runner, "fit_gp_marginal_likelihood", counted(
        "fit", functools.partial(runner.fit_gp_marginal_likelihood,
                                 outer_rounds=1, inner_steps=2)))
    cfg = port.RunConfig(dim=3, num_domain=30, num_boundary=8,
                         gp=port.GPConfig(gn_steps=4))
    _, fit = runner.fitted_config(cfg, "cpu")
    assert len(fit.table) == 8
    per_candidate = {(False, False): 2 * 3, (True, False): 1 * 3, (False, True): 2 * 3}
    assert parts["grid"] == {k: 4 * v for k, v in per_candidate.items()}
    assert parts["fit"] == {k: 8 * v for k, v in per_candidate.items()}
