"""Port's Picard schedules, recursion and ScaSML (scasml_gp_torch.picard)
against the JAX package.

The port draws its Monte-Carlo numbers from torch generators, which cannot
replay JAX's threefry keys, so rollouts are compared in distribution: per
point means and variances over repeated solves, and rel-L2 within MC error.
Deterministic pieces (tables, counters, terminal time, the quadrature
weights) are compared exactly or to float32 round-off.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import scasml_gp_torch as port  # noqa: E402
from scasml_gp_torch.equations.base import Equation  # noqa: E402
from scasml_gp_torch.gp.state import state_from_numpy  # noqa: E402
from scasml_gp_torch.picard import schedule as tsched  # noqa: E402
from scasml_gp_torch.picard.core import build_quadrature_uz  # noqa: E402
from scasml_gp_tpu.picard import schedule as jsched  # noqa: E402

torch.set_num_threads(2)

D = 4


# ---------------------------------------------------------------- schedules
@pytest.mark.parametrize("rho", [1, 2, 3, 4])
def test_schedule_tables_match_jax(rho):
    got = tsched.approx_parameters(rho, 0.5)
    want = jsched.approx_parameters(rho, 0.5, backend="python")
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_evaluation_counters_match_jax():
    for n in (1, 2, 3):
        for rho in range(n, 4):
            for fg in (False, True):
                assert tsched.count_evaluations_quadrature(n, rho, 0.5, fg) == \
                    jsched.count_evaluations_quadrature(n, rho, 0.5, fg)
        for M in (2, 3):
            for sv in (False, True):
                assert tsched.count_evaluations_full_history(n, M, sv, True) == \
                    jsched.count_evaluations_full_history(n, M, sv, True)


# ------------------------------------------------------- estimator correctness
@pytest.mark.parametrize("mf", [1, 2, 7])
@pytest.mark.parametrize("centered", [False, True])
def test_z_accum_and_var_of_mean_match_jax(mf, centered):
    """Same arrays into both packages' MC reductions: float32 sums of at
    most 7 terms of size ~1 agree to 1e-6."""
    from scasml_gp_torch.picard.core import _sample_var_of_mean, _z_accum
    from scasml_gp_tpu.picard import core as jcore

    rng = np.random.default_rng(mf + 10 * centered)
    vals = rng.standard_normal((6, mf)).astype(np.float32)
    weights = rng.standard_normal((6, mf, D)).astype(np.float32)
    got = _z_accum(torch.from_numpy(vals), torch.from_numpy(weights), mf, centered)
    want = jcore._z_accum(jnp.asarray(vals), jnp.asarray(weights), mf, centered)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    got_v = _sample_var_of_mean(torch.from_numpy(vals), mf)
    want_v = jcore._sample_var_of_mean(jnp.asarray(vals), mf)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-6,
                               atol=1e-6)


def test_terminal_time_is_deterministic():
    """At t = T every level reduces to u = g(x), z = 0."""
    eq = port.GradDependentNonlinear(n_input=D + 1)
    x = torch.rand((16, D), generator=torch.Generator().manual_seed(1)) - 0.5
    x_t = torch.cat([x, torch.full((16, 1), eq.T)], dim=1)
    uz = port.MLP(eq, device="cpu").uz_solve(2, 2, x_t)
    np.testing.assert_allclose(uz[:, 0].numpy(), eq.g(x_t)[:, 0].numpy(),
                               rtol=1e-4, atol=1e-4)


class _ConstantForcingEq(Equation):
    """f == C, g = sum(x): u(t, x) = sum(x) + mu d (T - t) + C (T - t)."""

    C = 0.37

    def sigma(self, x_t=0):
        return 0.5

    def mu(self, x_t=0):
        return 0.2

    def f(self, x_t, u, z):
        return torch.full_like(u, self.C)

    def terminal_constraint(self, x_t):
        return torch.sum(x_t[:, :-1], dim=1, keepdim=True)

    def exact_solution(self, x_t):
        dT = self.T - x_t[:, -1]
        return (torch.sum(x_t[:, :-1], dim=1) + self.mu() * self.dim * dT
                + self.C * dT)[:, None]


def test_quadrature_weights_integrate_constant_forcing():
    """The l = 0 interior term integrates f == C exactly to C (T - t); what
    remains is the terminal MC noise of MC_g = 2 samples."""
    eq = _ConstantForcingEq(n_input=D + 1)
    eq.norm_estimation = 100.0
    x_t = 0.9 * torch.rand((48, D + 1), generator=torch.Generator().manual_seed(5)) - 0.5
    u = port.MLP(eq, device="cpu").u_solve(1, 2, x_t).numpy().ravel()
    exact = eq.exact_solution(x_t).numpy().ravel()
    dT = 0.5 - x_t[:, -1].numpy()
    tol = 5 * 0.5 * np.sqrt(D * dT / 2) + 1e-3
    assert np.all(np.abs(u - exact) < tol), np.abs(u - exact).max()


def test_unported_options_raise(carried):
    eq, gp = carried["eq"], carried["gp"]
    with pytest.raises(NotImplementedError):
        port.ScaSML(eq, gp, terminal_crn=True)
    with pytest.raises(NotImplementedError):
        port.ScaSML(eq, gp, mesh=object())
    with pytest.raises(NotImplementedError):
        port.MLP(eq, terminal_crn=True, device="cpu")


# ------------------------------------------------ ScaSML on a carried state
@pytest.fixture(scope="module")
def carried():
    """A GP trained by the JAX package (the test_picard.py configuration),
    carried into the port with state_from_numpy."""
    from scasml_gp_tpu.config import GPConfig
    from scasml_gp_tpu.equations import GradDependentNonlinear
    from scasml_gp_tpu.gp import GPGradDependentNonlinear

    eq_j = GradDependentNonlinear(n_input=D + 1)
    gp_j = GPGradDependentNonlinear(eq_j, GPConfig(gn_steps=12))
    x_dom, x_bdy = eq_j.generate_data(200, 60, key=jax.random.PRNGKey(0))
    gp_j.GPsolver(x_dom, x_bdy)
    x_test, _ = eq_j.generate_test_data(200, 1, key=jax.random.PRNGKey(4))

    eq = port.GradDependentNonlinear(n_input=D + 1)
    gp = port.GPGradDependentNonlinear(eq, device="cpu")
    gp.state = state_from_numpy(
        {k: np.asarray(v) for k, v in gp_j.state._asdict().items()}, "cpu")
    x_np = np.array(x_test)
    return {
        "eq_j": eq_j, "gp_j": gp_j, "eq": eq, "gp": gp, "x_np": x_np,
        "x": torch.from_numpy(x_np),
        "exact": np.asarray(eq_j.exact_solution(x_test)).ravel(),
    }


def _rel_l2(pred, exact):
    return np.linalg.norm(np.ravel(pred) - exact) / np.linalg.norm(exact)


def test_skip_zero_fbreve_is_bitwise_exact(carried):
    """Skipping the level-0 f_breve sweeps (f_zero_at_zero) changes no bit:
    those terms are exactly zero and draw no random numbers."""
    sca = port.ScaSML(carried["eq"], carried["gp"])
    model = sca._model()
    assert model.f_zero_at_zero
    x_t = carried["x"][:16]
    tables = tsched.approx_parameters(2, carried["eq"].T)
    fast = build_quadrature_uz(model, 2, 2, tables)(
        x_t, torch.Generator().manual_seed(9), sca._params())
    slow = build_quadrature_uz(model._replace(f_zero_at_zero=False), 2, 2, tables)(
        x_t, torch.Generator().manual_seed(9), sca._params())
    assert torch.equal(fast, slow)


def test_variance_column_leaves_u_z_unchanged(carried):
    """want_variance appends the top-level MC variance of u and draws no
    extra random numbers: with the same seed the [u, z] columns are the
    same bits, and the variance column is finite and non-negative."""
    sca = port.ScaSML(carried["eq"], carried["gp"])
    model = sca._model()
    x_t = carried["x"][:16]
    tables = tsched.approx_parameters(2, carried["eq"].T)
    plain = build_quadrature_uz(model, 2, 2, tables)(
        x_t, torch.Generator().manual_seed(3), sca._params())
    with_var = build_quadrature_uz(model, 2, 2, tables, want_variance=True)(
        x_t, torch.Generator().manual_seed(3), sca._params())
    assert with_var.shape == (16, 2 + D)
    assert torch.equal(with_var[:, :-1], plain)
    var = with_var[:, -1]
    assert torch.isfinite(var).all() and (var >= 0).all() and (var > 0).any()


def test_scasml_rel_l2_matches_jax_and_beats_gp(carried):
    """Same surrogate, same test points: the GP agrees to float32 round-off,
    and ScaSML's rel-L2 agrees with the JAX package's within MC error.  Over
    repeated solves of this problem the rel-L2 of either package spreads by
    ~0.002 (one standard deviation), so 0.01 is five of them."""
    from scasml_gp_tpu.picard import ScaSML as JaxScaSML

    exact = carried["exact"]
    e_gp_j = _rel_l2(np.asarray(carried["gp_j"].predict(jnp.asarray(carried["x_np"]))),
                     exact)
    e_gp = _rel_l2(carried["gp"].predict(carried["x"]).numpy(), exact)
    assert abs(e_gp - e_gp_j) < 1e-4 * e_gp_j
    e_j = _rel_l2(np.asarray(JaxScaSML(carried["eq_j"], carried["gp_j"]).u_solve(
        2, 2, jnp.asarray(carried["x_np"]))), exact)
    e_t = _rel_l2(port.ScaSML(carried["eq"], carried["gp"]).u_solve(
        2, 2, carried["x"]).numpy(), exact)
    assert abs(e_t - e_j) < 0.01, (e_t, e_j)
    assert e_t < e_gp, (e_t, e_gp)


def test_scasml_matches_jax_in_distribution(carried):
    """Per point, over 40 independent solves each: the port's mean agrees with
    the JAX package's within the standard error (mean |z| of a standard normal
    is 0.80), and the variances agree within 20% (40 samples per side, 200
    points averaged)."""
    from scasml_gp_tpu.picard import ScaSML as JaxScaSML

    R = 40
    xj = jnp.asarray(carried["x_np"])
    sj = JaxScaSML(carried["eq_j"], carried["gp_j"])
    uj = np.stack([np.asarray(sj.u_solve(2, 2, xj)).ravel() for _ in range(R)])
    st = port.ScaSML(carried["eq"], carried["gp"], seed=100)
    ut = np.stack([st.u_solve(2, 2, carried["x"]).numpy().ravel()
                   for _ in range(R)])
    z = (uj.mean(0) - ut.mean(0)) / np.sqrt((uj.var(0) + ut.var(0)) / R)
    assert np.mean(np.abs(z)) < 1.0, np.mean(np.abs(z))
    ratio = ut.var(0).mean() / uj.var(0).mean()
    assert 0.8 < ratio < 1.25, ratio


def test_scasml_solve_makes_the_main_path_posterior_calls(carried, monkeypatch):
    """One u_solve(2, 2) evaluates the posterior 20 times (19 in the rollout,
    1 for u_hat) in the three forms the CUDA kernel specialises; on a GPU each
    is one kernel launch."""
    from scasml_gp_torch.gp.solver import GP

    calls = {}
    orig = GP.posterior_u

    def counting(self, params, x_t, want_grad=False, want_ops=False):
        key = (want_grad, want_ops)
        calls[key] = calls.get(key, 0) + 1
        return orig(self, params, x_t, want_grad, want_ops)

    monkeypatch.setattr(GP, "posterior_u", counting)
    sca = port.ScaSML(carried["eq"], carried["gp"])
    u = sca.u_solve(2, 2, carried["x"])
    assert u.shape == (200, 1) and torch.isfinite(u).all()
    assert calls == {(False, False): 5, (True, False): 3, (False, True): 12}
    assert sca.evaluation_counter == tsched.count_evaluations_quadrature(
        2, 2, 0.5, count_fg=True)


def test_batch_chunking_keeps_rows(carried):
    """Chunked solves pad the last chunk and drop the pad rows; the result
    differs only by the random numbers drawn."""
    x = carried["x"][:50]
    a = port.ScaSML(carried["eq"], carried["gp"]).u_solve(2, 2, x)
    b = port.ScaSML(carried["eq"], carried["gp"], batch_chunk=16).u_solve(2, 2, x)
    assert a.shape == b.shape == (50, 1)
    exact = carried["exact"][:50]
    assert _rel_l2(a.numpy(), exact) < 0.1 and _rel_l2(b.numpy(), exact) < 0.1
