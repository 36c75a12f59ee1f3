"""Port's full-history recursion, MLPFullHistory and ScaSMLFullHistory
(scasml_gp_torch.picard) against the JAX package.

The port draws from torch generators, which cannot replay JAX's threefry
keys, so rollouts are compared in distribution: per point means and
variances over 40 solves a side.  Deterministic facts (the zero-skip, the
variance column, posterior call counts, the evaluation counter) are compared
exactly.
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
from scasml_gp_torch.picard.core import build_full_history_uz  # noqa: E402
from scasml_gp_tpu.picard import schedule as jsched  # noqa: E402

torch.set_num_threads(2)

D = 4


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


# ------------------------------------------------------- estimator correctness
class _LinearEq(Equation):
    """f == C, g = sum(x): u(t, x) = sum(x) + mu d (T - t) + C (T - t)."""

    C = 0.0

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


class _ConstantForcingEq(_LinearEq):
    C = 0.37


@pytest.mark.parametrize("eq_cls", [_LinearEq, _ConstantForcingEq])
@pytest.mark.parametrize("sampling", ["uniform", "sqrt"])
def test_full_history_linear_pde_matches_mc_oracle(eq_cls, sampling):
    """n = 1, M = 4096 (tests/test_picard.py:88): u is the terminal mean of
    a linear g, exact in expectation with std sigma sqrt(d (T - t) / M), plus
    the interior integral of f == C.  Uniform times integrate it exactly;
    'sqrt' times carry weights 2v of std 0.58, i.e. C (T - t) 0.58 / 64 <
    2e-3 of extra noise, inside the 1e-3 + 5-sigma bar."""
    eq = eq_cls(n_input=D + 1)
    eq.norm_estimation = 100.0
    x_t = 0.9 * torch.rand((64, D + 1), generator=torch.Generator().manual_seed(0)) - 0.5
    u = port.MLPFullHistory(eq, time_sampling=sampling, device="cpu").u_solve(
        1, None, x_t, M=4096).numpy().ravel()
    exact = eq.exact_solution(x_t).numpy().ravel()
    dT = 0.5 - x_t[:, -1].numpy()
    tol = 5 * 0.5 * np.sqrt(D * dT / 4096) + 1e-3 + (0.004 if sampling == "sqrt" else 0)
    assert np.all(np.abs(u - exact) < tol), np.abs(u - exact).max()


def test_terminal_time_is_deterministic():
    """At t = T every level reduces to u = g(x), z = 0."""
    eq = port.GradDependentNonlinear(n_input=D + 1)
    x = torch.rand((16, D), generator=torch.Generator().manual_seed(1)) - 0.5
    x_t = torch.cat([x, torch.full((16, 1), eq.T)], dim=1)
    uz = port.MLPFullHistory(eq, device="cpu").uz_solve(2, None, x_t, M=3)
    np.testing.assert_allclose(uz[:, 0].numpy(), eq.g(x_t)[:, 0].numpy(),
                               rtol=1e-4, atol=1e-4)


# ------------------------------------------------ ScaSML on a carried state
def test_skip_zero_fbreve_is_bitwise_exact(carried):
    """Skipping the level-0 f_breve sweeps changes no bit: those terms are
    exactly zero and draw no random numbers."""
    sca = port.ScaSMLFullHistory(carried["eq"], carried["gp"])
    model = sca._model()
    assert model.f_zero_at_zero
    x_t = carried["x"][:16]
    fast = build_full_history_uz(model, 2, 3)(
        x_t, torch.Generator().manual_seed(9), sca._params())
    slow = build_full_history_uz(model._replace(f_zero_at_zero=False), 2, 3)(
        x_t, torch.Generator().manual_seed(9), sca._params())
    assert torch.equal(fast, slow)


@pytest.mark.parametrize("sampling", ["uniform", "sqrt"])
def test_variance_column_leaves_u_z_unchanged(carried, sampling):
    """want_variance draws no extra numbers: same seed, same [u, z] bits; the
    variance column is finite and non-negative."""
    sca = port.ScaSMLFullHistory(carried["eq"], carried["gp"], time_sampling=sampling)
    model = sca._model()
    x_t = carried["x"][:16]
    plain = build_full_history_uz(model, 2, 3)(
        x_t, torch.Generator().manual_seed(3), sca._params())
    with_var = build_full_history_uz(model, 2, 3, want_variance=True)(
        x_t, torch.Generator().manual_seed(3), sca._params())
    assert with_var.shape == (16, 2 + D)
    assert torch.equal(with_var[:, :-1], plain)
    var = with_var[:, -1]
    assert torch.isfinite(var).all() and (var >= 0).all() and (var > 0).any()


def test_scasml_rel_l2_matches_jax_and_beats_gp(carried):
    """Same surrogate, same points: ScaSMLFullHistory's rel-L2 agrees with
    the JAX package's within 0.01 (five standard deviations of the spread
    over repeated solves, ~0.002) and is below the GP's."""
    from scasml_gp_tpu.picard import ScaSMLFullHistory as JaxScaSMLFH

    exact = carried["exact"]
    e_gp = _rel_l2(carried["gp"].predict(carried["x"]).numpy(), exact)
    e_j = _rel_l2(np.asarray(JaxScaSMLFH(carried["eq_j"], carried["gp_j"]).u_solve(
        2, None, jnp.asarray(carried["x_np"]), M=3)), exact)
    e_t = _rel_l2(port.ScaSMLFullHistory(carried["eq"], carried["gp"]).u_solve(
        2, 2, carried["x"], M=3).numpy(), exact)
    assert abs(e_t - e_j) < 0.01, (e_t, e_j)
    assert e_t < e_gp, (e_t, e_gp)


@pytest.mark.parametrize("kind", ["ScaSML", "MLP"])
@pytest.mark.parametrize("sampling", ["uniform", "sqrt"])
def test_matches_jax_in_distribution(carried, kind, sampling):
    """Per point, over 40 independent solves of u_solve(2, M=3) each: the
    port's mean agrees with the JAX package's within the standard error
    (mean |z| of a standard normal is 0.80, so < 1 over 200 points), and the
    mean variances agree within [0.8, 1.25] (40 samples per side)."""
    from scasml_gp_tpu import picard as jpicard

    R = 40
    xj = jnp.asarray(carried["x_np"])
    if kind == "ScaSML":
        sj = jpicard.ScaSMLFullHistory(carried["eq_j"], carried["gp_j"],
                                       time_sampling=sampling)
        st = port.ScaSMLFullHistory(carried["eq"], carried["gp"], seed=100,
                                    time_sampling=sampling)
    else:
        sj = jpicard.MLPFullHistory(carried["eq_j"], time_sampling=sampling)
        st = port.MLPFullHistory(carried["eq"], seed=100, time_sampling=sampling, device="cpu")
    uj = np.stack([np.asarray(sj.u_solve(2, None, xj, M=3)).ravel()
                   for _ in range(R)])
    ut = np.stack([st.u_solve(2, None, carried["x"], M=3).numpy().ravel()
                   for _ in range(R)])
    z = (uj.mean(0) - ut.mean(0)) / np.sqrt((uj.var(0) + ut.var(0)) / R)
    assert np.mean(np.abs(z)) < 1.0, np.mean(np.abs(z))
    ratio = ut.var(0).mean() / uj.var(0).mean()
    assert 0.8 < ratio < 1.25, ratio


def _count_posterior_calls(monkeypatch):
    """Record (want_grad, want_ops, rows) of every GP.posterior_u call; on a
    GPU each is one launch of the fused kernel."""
    from scasml_gp_torch.gp.solver import GP

    calls = []
    orig = GP.posterior_u

    def counting(self, params, x_t, want_grad=False, want_ops=False):
        calls.append((want_grad, want_ops, x_t.shape[0]))
        return orig(self, params, x_t, want_grad, want_ops)

    monkeypatch.setattr(GP, "posterior_u", counting)
    return calls


def test_scasml_solve_makes_the_pinned_posterior_calls(carried, monkeypatch):
    """One ScaSMLFullHistory.u_solve(2, 2, M=3) on B points: g_breve on the
    M^2 B top terminal rows, the M B level-1 node's M B terminal rows and
    u_hat's B rows; f_breve once on the level-1 node's M B rows; the leaf
    residual on the M^2 B level-0 samples of each node."""
    calls = _count_posterior_calls(monkeypatch)
    sca = port.ScaSMLFullHistory(carried["eq"], carried["gp"])
    u = sca.u_solve(2, 2, carried["x"], M=3)
    B = 200
    assert u.shape == (B, 1) and torch.isfinite(u).all()
    assert sorted(calls) == sorted([
        (False, False, 9 * B), (False, False, 9 * B), (False, False, B),
        (True, False, 3 * B),
        (False, True, 9 * B), (False, True, 9 * B),
    ])
    assert sca.evaluation_counter == jsched.count_evaluations_full_history(
        2, 3, scasml_variant=True, count_fg=True)


def test_judge_rollout_makes_five_posterior_calls(carried, monkeypatch):
    """The tuner's judge, uz_solve(2, M=8) on B points, makes 5 calls: two
    g_breve and two leaf sweeps of 64 B rows and one f_breve of 8 B rows."""
    calls = _count_posterior_calls(monkeypatch)
    B = 50
    sca = port.ScaSMLFullHistory(carried["eq"], carried["gp"])
    sca.uz_solve(2, None, carried["x"][:B], M=8)
    assert sorted(calls) == sorted([
        (False, False, 64 * B), (False, False, 64 * B), (True, False, 8 * B),
        (False, True, 64 * B), (False, True, 64 * B),
    ])


def test_mlp_counter_matches_jax():
    eq = port.GradDependentNonlinear(n_input=D + 1)
    solver = port.MLPFullHistory(eq, device="cpu")
    solver.u_solve(1, None, torch.zeros((8, D + 1)), M=2)
    assert solver.evaluation_counter == jsched.count_evaluations_full_history(1, 2)
    assert tsched.count_evaluations_full_history(2, 3, True, True) == \
        jsched.count_evaluations_full_history(2, 3, True, True)


def test_batch_chunking_keeps_rows(carried):
    """Chunked solves pad the last chunk and drop the pad rows; the result
    differs only by the random numbers drawn."""
    x = carried["x"][:50]
    exact = carried["exact"][:50]
    for cls, args, kw in ((port.ScaSMLFullHistory, (carried["eq"], carried["gp"]), {}),
                          (port.MLPFullHistory, (carried["eq"],), {"device": "cpu"})):
        a = cls(*args, **kw).u_solve(2, None, x, M=3)
        b = cls(*args, batch_chunk=16, **kw).u_solve(2, None, x, M=3)
        assert a.shape == b.shape == (50, 1)
        assert not torch.equal(a, b)
        assert _rel_l2(a.numpy(), exact) < 0.5 and _rel_l2(b.numpy(), exact) < 0.5


def test_unported_options_raise(carried):
    eq, gp = carried["eq"], carried["gp"]
    with pytest.raises(NotImplementedError):
        port.ScaSMLFullHistory(eq, gp, terminal_crn=True)
    with pytest.raises(NotImplementedError):
        port.ScaSMLFullHistory(eq, gp, mesh=object())
    with pytest.raises(NotImplementedError):
        port.MLPFullHistory(eq, terminal_crn=True, device="cpu")
    # the JAX kwargs at their defaults are accepted, and debug_checks, once
    # unported, is on (tests/test_torch_debug_checks.py)
    port.MLPFullHistory(eq, mesh=None, debug_checks=False, device="cpu")
    assert port.MLPFullHistory(eq, debug_checks=True, device="cpu").debug_checks
