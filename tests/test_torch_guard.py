"""Port's ScaSML variance guard (scasml_gp_torch.picard.scasml) against the
JAX package.

The guard's arithmetic (``_guarded_u``, ``_measured_probe_ratio``) gets the
same arrays in both packages: outputs agree to 1e-6 and lambda to 1e-5
(float32 sums of at most 40 terms).  The schedule ladders run through a stub
``_u_solve_at`` that scripts lambda, so both packages must try the same
candidates, return the same candidate and report the same lambda.  The
evaluation counter, with the JAX package's ``//2`` charge for quadrature
probes, must match exactly.  The rest holds the port's guarded solves to the
JAX package's own asserts (tests/test_variance.py) in distribution.
"""

from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import scasml_gp_torch as port  # noqa: E402
from scasml_gp_torch.gp.state import state_from_numpy  # noqa: E402
from scasml_gp_torch.picard import scasml as tsca  # noqa: E402
from scasml_gp_torch.picard.schedule import count_evaluations_quadrature  # noqa: E402
from scasml_gp_tpu.picard import scasml as jsca  # noqa: E402

torch.set_num_threads(2)

D, B = 4, 40


def _fake(mod, cls, backend, guard, clip, u_hat, std, eq=None):
    """A solver with only what the guard reads: the GP's mean and std."""
    obj = getattr(mod, cls).__new__(getattr(mod, cls))
    wrap = torch.from_numpy if backend == "torch" else jnp.asarray
    obj.variance_guard, obj.adaptive_clip, obj.last_lambda = guard, clip, None
    obj.last_ladder = []
    obj.GP = SimpleNamespace(predict=lambda x: wrap(u_hat),
                             predict_std=lambda x: wrap(std))
    obj.equation = eq
    obj.device = torch.device("cpu")
    return obj


def _arrays(regime, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    if regime == "signal":      # correction well above its noise
        ub = f(B, 1)
        a, b = ub + 0.1 * f(B, 1), ub + 0.1 * f(B, 1)
    elif regime == "noise":     # correction indistinguishable from noise
        ub = 0.1 * f(B, 1)
        a, b = 0.14 * f(B, 1), 0.14 * f(B, 1)
    else:                       # the probes expose a dominating bias
        ub = 0.3 * f(B, 1)
        a, b = ub + 0.5 + 0.05 * f(B, 1), ub + 0.5 + 0.05 * f(B, 1)
    var = np.abs(0.01 * f(B, 1)).astype(np.float32)
    out = np.concatenate([ub, f(B, D), var], axis=1)
    u_hat, std = f(B, 1), np.abs(0.3 * f(B, 1)).astype(np.float32)
    return out, a, b, u_hat, std


@pytest.mark.parametrize("regime", ["signal", "noise", "bias"])
@pytest.mark.parametrize("probes", [False, True])
@pytest.mark.parametrize("num_valid", [None, 25])
@pytest.mark.parametrize("clip", [None, 0.8])
def test_guarded_u_matches_jax(regime, probes, num_valid, clip):
    out, a, b, u_hat, std = _arrays(regime)
    results = {}
    for backend, mod, wrap in (("torch", tsca, torch.from_numpy),
                               ("jax", jsca, jnp.asarray)):
        for guard in (True, False):
            obj = _fake(mod, "_ScaSMLBase", backend, guard, clip, u_hat, std)
            half = (wrap(a), wrap(b)) if probes else None
            u = obj._guarded_u(wrap(out), None, u_breve_half=half,
                               num_valid=num_valid, probe_var_ratio=0.3)
            results[backend, guard] = (np.asarray(u), obj.last_lambda)
    for guard in (True, False):
        (ut, lt), (uj, lj) = results["torch", guard], results["jax", guard]
        np.testing.assert_allclose(ut, uj, rtol=1e-6, atol=1e-6)
        if guard:
            assert abs(lt - lj) <= 1e-5, (lt, lj)
            assert 0.0 <= lt <= 1.0
        else:
            assert lt is None and lj is None
    if probes and regime == "bias":
        assert results["torch", True][1] == 0.0   # bias-dominance abstention


@pytest.mark.parametrize("case", ["plain", "num_valid", "degenerate", "above_one",
                                  "tiny"])
def test_measured_probe_ratio_matches_jax(case):
    out, a, b, _, _ = _arrays("signal", seed=1)
    a_out, b_out = out.copy(), out.copy()
    a_out[:, -1] *= 3.0
    b_out[:, -1] *= 5.0
    num_valid = 17 if case == "num_valid" else None
    if case == "degenerate":
        out[:, -1] = 0.0
    elif case == "above_one":
        a_out[:, -1] *= 0.01
        b_out[:, -1] *= 0.01
    elif case == "tiny":
        out[:, -1] *= 1e-6
    got = tsca._ScaSMLBase._measured_probe_ratio(
        None, torch.from_numpy(out), torch.from_numpy(a_out),
        torch.from_numpy(b_out), 0.37, num_valid=num_valid)
    want = jsca._ScaSMLBase._measured_probe_ratio(
        None, jnp.asarray(out), jnp.asarray(a_out), jnp.asarray(b_out), 0.37,
        num_valid=num_valid)
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)
    if case == "degenerate":
        assert got == 0.37


def _ladder_fake(mod, cls, backend, lambdas, escalate=True):
    eq = SimpleNamespace(escalate_M=escalate, escalate_M_accept=0.5,
                         escalate_M_max=12)
    wrap = torch.from_numpy if backend == "torch" else jnp.asarray
    obj = _fake(mod, cls, backend, True, None, np.full((4, 1), 7.0, np.float32),
                None, eq=eq)
    obj.calls = []

    def solve_at(*args, **kwargs):
        obj.calls.append(args)
        obj.last_lambda = lambdas[len(obj.calls) - 1]
        return wrap(np.full((4, 1), float(len(obj.calls)), np.float32))

    obj._u_solve_at = solve_at
    return obj


LAMBDA_SCRIPTS = {"abstain": [0.2, 0.4, 0.45, 0.3, 0.1],
                  "second": [0.2, 0.8, 0.9, 0.9, 0.9],
                  "first": [0.7, 0.1, 0.1, 0.1, 0.1]}


@pytest.mark.parametrize("script", sorted(LAMBDA_SCRIPTS))
@pytest.mark.parametrize("n,M", [(1, 2), (2, 3), (2, 4), (3, 6), (2, 8), (2, 12),
                                 (1, 13)])
def test_full_history_ladder_matches_jax(script, n, M):
    """(1, 2M), (1, 4M), ... up to escalate_M_max = 12, then (n, M)."""
    lambdas = LAMBDA_SCRIPTS[script]
    ft = _ladder_fake(tsca, "ScaSMLFullHistory", "torch", lambdas)
    fj = _ladder_fake(jsca, "ScaSMLFullHistory", "jax", lambdas)
    ut = ft.u_solve(n, None, torch.zeros((4, D + 1)), M=M)
    uj = fj.u_solve(n, None, jnp.zeros((4, D + 1)), M=M)
    cand = lambda calls: [(c[0], c[3]) for c in calls]  # noqa: E731
    assert cand(ft.calls) == cand(fj.calls)
    assert [c for c, _ in ft.last_ladder] == cand(ft.calls)
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    assert ft.last_lambda == fj.last_lambda
    if script == "abstain":
        assert float(ut[0, 0]) == 7.0 and ft.last_lambda == 0.0


@pytest.mark.parametrize("script", sorted(LAMBDA_SCRIPTS))
@pytest.mark.parametrize("n,rho", [(1, 2), (2, 2), (3, 3)])
def test_quadrature_ladder_matches_jax(script, n, rho):
    """(1, rho), (1, rho + 1), then (n, rho) when n > 1."""
    lambdas = LAMBDA_SCRIPTS[script]
    ft = _ladder_fake(tsca, "ScaSML", "torch", lambdas)
    fj = _ladder_fake(jsca, "ScaSML", "jax", lambdas)
    ut = ft.u_solve(n, rho, torch.zeros((4, D + 1)))
    uj = fj.u_solve(n, rho, jnp.zeros((4, D + 1)))
    cand = lambda calls: [c[:2] for c in calls]  # noqa: E731
    assert cand(ft.calls) == cand(fj.calls)
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    assert ft.last_lambda == fj.last_lambda


@pytest.mark.parametrize("cls", ["ScaSML", "ScaSMLFullHistory"])
def test_no_ladder_without_escalate(cls):
    ft = _ladder_fake(tsca, cls, "torch", [0.1], escalate=False)
    fj = _ladder_fake(jsca, cls, "jax", [0.1], escalate=False)
    args = (2, 2) if cls == "ScaSML" else (2, None)
    kw = {} if cls == "ScaSML" else {"M": 5}
    ft.u_solve(*args, torch.zeros((4, D + 1)), **kw)
    fj.u_solve(*args, jnp.zeros((4, D + 1)), **kw)
    assert len(ft.calls) == len(fj.calls) == 1
    assert ft.calls[0][:2] == fj.calls[0][:2]


# ------------------------------------------------ guarded solves, real GPs
@pytest.fixture(scope="module")
def carried():
    """A GradDependentNonlinear GP trained by the JAX package, carried over."""
    from scasml_gp_tpu.config import GPConfig
    from scasml_gp_tpu.equations import GradDependentNonlinear
    from scasml_gp_tpu.gp import GPGradDependentNonlinear

    eq_j = GradDependentNonlinear(n_input=D + 1)
    gp_j = GPGradDependentNonlinear(eq_j, GPConfig(gn_steps=6))
    x_dom, x_bdy = eq_j.generate_data(80, 20, key=jax.random.PRNGKey(0))
    gp_j.GPsolver(x_dom, x_bdy)
    eq = port.GradDependentNonlinear(n_input=D + 1)
    gp = port.GPGradDependentNonlinear(eq, device="cpu")
    gp.state = state_from_numpy(
        {k: np.asarray(v) for k, v in gp_j.state._asdict().items()}, "cpu")
    x = eq.geometry().sample_domain(torch.Generator().manual_seed(1), 24)
    return eq_j, gp_j, eq, gp, x


def test_guarded_evaluation_counter_matches_jax(carried):
    """Quadrature: the rollout plus two probes, each charged
    count_evaluations_quadrature(...) // 2; full history at M = 4: the
    rollout plus two M // 2 rollouts."""
    eq_j, gp_j, eq, gp, x = carried
    xj = jnp.asarray(x.numpy())
    qt = port.ScaSML(eq, gp, variance_guard=True)
    qj = jsca.ScaSML(eq_j, gp_j, variance_guard=True)
    qt.u_solve(2, 2, x)
    qj.u_solve(2, 2, xj)
    full = count_evaluations_quadrature(2, 2, eq.T, count_fg=True)
    assert qt.evaluation_counter == qj.evaluation_counter == full + 2 * (full // 2)
    ft = port.ScaSMLFullHistory(eq, gp, variance_guard=True)
    fj = jsca.ScaSMLFullHistory(eq_j, gp_j, variance_guard=True)
    ft.u_solve(2, None, x, M=4)
    fj.u_solve(2, None, xj, M=4)
    assert ft.evaluation_counter == fj.evaluation_counter
    for solver in (qt, ft):
        assert 0.0 <= solver.last_lambda <= 1.0


def test_batch_chunk_does_not_change_lambda(carried):
    """lambda is a statistic over the whole batch: with a deterministic
    rollout, a solve in chunks of 7 (the last one padded) gives the same
    lambda and output as one in a single block."""
    _, _, eq, gp, x = carried

    def rollout(key):
        def fn(x_t, gen, params):
            s = float(sum(k for k in key if isinstance(k, int)))
            u = torch.sin(3.0 * x_t[:, :1] + s) * 0.1 + x_t[:, -1:] * 0.05
            var = 1e-4 * (1.0 + x_t[:, 1:2] ** 2)
            return torch.cat([u, x_t[:, :-1], var], dim=1)
        return fn

    outs = []
    for chunk in (None, 7):
        sca = port.ScaSMLFullHistory(eq, gp, variance_guard=True, batch_chunk=chunk)
        sca._get_fn = rollout
        outs.append((sca.u_solve(2, None, x, M=4), sca.last_lambda))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    assert outs[0][1] == outs[1][1]


def test_measured_probe_ratio_on_rollouts(carried):
    """tests/test_variance.py on the port: the M = 2 probes are noisier
    than the M = 4 rollout, so the measured ratio lies in (0, 1)."""
    _, _, eq, gp, x = carried
    sca = port.ScaSMLFullHistory(eq, gp, variance_guard=True)
    out = sca.uz_solve(2, None, x, M=4)
    a = sca.uz_solve(2, None, x, M=2)
    b = sca.uz_solve(2, None, x, M=2)
    assert out.shape == (x.shape[0], D + 2)
    assert 0.0 < sca._measured_probe_ratio(out, a, b, fallback=0.25) < 1.0
    u = sca.u_solve(2, None, x, M=4)
    assert torch.isfinite(u).all() and 0.0 <= sca.last_lambda <= 1.0


def test_adaptive_clip_bounds_the_correction():
    """|u - u_hat| <= k predict_std(x) per point (tests/test_variance.py)."""
    eq = port.GradDependentNonlinear(n_input=D + 1)
    gp = port.GPGradDependentNonlinear(eq, port.GPConfig(gn_steps=6), device="cpu")
    gp.GPsolver(*eq.generate_data(100, 24, torch.Generator().manual_seed(0)))
    x = eq.geometry().sample_domain(torch.Generator().manual_seed(4), 32)
    sca = port.ScaSMLFullHistory(eq, gp, adaptive_clip=3.0, seed=9)
    u = sca.u_solve(2, None, x, M=3)
    bound = 3.0 * gp.predict_std(x)
    assert torch.isfinite(u).all()
    assert torch.all((u - gp.predict(x)).abs() <= bound + 1e-6)


def test_guarded_quadrature_on_the_converged_hjb_surrogate():
    """tests/test_variance.py on the port: on the exact mixture surrogate the
    correction is noise, so the guard shrinks it (lambda < 0.9) and the
    output stays within the shrink interval of the GP."""
    eq = port.HJB(n_input=D + 1)
    gp = port.GPHJBColeHopf(eq, device="cpu")
    gp.GPsolver(*eq.generate_data(400, 100, torch.Generator().manual_seed(0)))
    sca = port.ScaSML(eq, gp)
    assert sca.variance_guard
    x = eq.geometry().sample_domain(torch.Generator().manual_seed(2), 64)
    u = sca.u_solve(2, 2, x)
    assert torch.isfinite(u).all()
    assert 0.0 <= sca.last_lambda < 0.9, sca.last_ladder
    assert [c for c, _ in sca.last_ladder][0] == (1, 2)
    dev = float((u - gp.predict(x)).norm())
    assert dev <= 1.5 * float(sca.uz_solve(2, 2, x)[:, :1].norm()) + 1e-6
