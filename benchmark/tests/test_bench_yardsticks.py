"""The frozen yardsticks: the operation counts equal the port's
``measure.py``, the posterior rows counted a request equal those the port
evaluates, the train's count is the formula written out, and every share
reads at most 100% for a time at the bound."""

import collections
import types

import pytest
import torch

from benchmark import work
from benchmark.harness import reader
from conftest import ROOT


@pytest.mark.parametrize("F", [4, 21, 81, 251])
@pytest.mark.parametrize("flags", [(False, False), (True, False), (False, True), (True, True)])
def test_pair_flops_and_bound_equal_measure(F, flags):
    from scasml_gp_torch import measure

    assert work.pair_flops(F, *flags) == measure.pair_flops(F, *flags)
    for n, m in ((64, 1200), (4096, 1200), (10800, 1200), (3, 8704)):
        assert work.bound(n, m, F, *flags) == measure.bound(n, m, F, *flags)
    assert (work.FP32_PEAK, work.HBM_RATE) == (measure.FP32_PEAK, measure.HBM_RATE)


def _port_rows(solver_name, n, kw, rows=5):
    """The posterior rows of each kind one u_solve of the port evaluates on
    the CPU."""
    import scasml_gp_torch as port
    from scasml_gp_torch.gp import solver as S

    seen = collections.Counter()
    orig = S.GP.posterior_u

    def counted(self, params, x_t, want_grad=False, want_ops=False):
        seen["grad" if want_grad else ("ops" if want_ops else "u")] += x_t.shape[0]
        return orig(self, params, x_t, want_grad, want_ops)

    eq = port.GradDependentNonlinear(n_input=4)
    gp = port.GPGradDependentNonlinear(eq, port.GPConfig(gn_steps=2), device="cpu")
    xd, xb = eq.generate_data(24, 6, torch.Generator().manual_seed(0))
    gp.GPsolver(xd, xb)
    x = torch.rand((rows, 4), generator=torch.Generator().manual_seed(1))
    S.GP.posterior_u = counted
    try:
        if solver_name == "quadrature":
            port.ScaSML(eq, gp).u_solve(n, kw["rho"], x)
        else:
            port.ScaSMLFullHistory(eq, gp).u_solve(n, None, x, M=kw["M"])
    finally:
        S.GP.posterior_u = orig
    return {k: seen.get(k, 0) for k in ("u", "grad", "ops")}


@pytest.mark.parametrize("solver,n,kw", [
    ("quadrature", 2, {"rho": 2}), ("quadrature", 1, {"rho": 3}),
    ("full_history", 2, {"M": 3}), ("full_history", 3, {"M": 2})])
def test_posterior_rows_equal_the_ports(solver, n, kw):
    assert work.posterior_rows(solver, n, rows=5, **kw) == _port_rows(solver, n, kw)


def test_predict_rows_and_request_work():
    assert work.posterior_rows("predict", 2, rows=7) == {"u": 7, "grad": 0, "ops": 0}
    flops, bound_s = work.request_work("predict", 1000, 81, 1200, n=2)
    assert flops == 1000 * 1200 * (2 * 81 + 25)
    assert bound_s == work.bound(1000, 1200, 81, False, False)[0] / 1e3


def test_train_flops_written_out():
    N, Nb, F, steps = 1000, 200, 21, 20
    phi = 4 * N + Nb
    want = (2 * F * (N + Nb) ** 2 + phi**3
            + steps * (2 * (3 * N) ** 3 / 3 + 18 * phi**2))
    assert work.train_flops(N, Nb, F, steps) == pytest.approx(want, rel=1e-12)


def _reader(name):
    return reader(ROOT, name)


def _fake_run(config, endpoint, rows, kernel_s, window_s, items):
    ops = [("void fused_posterior_kernel<false>", 0.0, kernel_s),
           ("fused_posterior_reduce", kernel_s, kernel_s)]
    return types.SimpleNamespace(
        config=config, traffic={"endpoint": endpoint},
        log=[{"rows": r, "traced": True} for r in rows],
        tr={"ops": ops, "window_s": window_s, "busy_s": kernel_s, "items": items})


@pytest.mark.parametrize("cfg", [
    {"solver": "quadrature", "n": 2, "rho": 2, "dim": 20},
    {"solver": "full_history", "n": 2, "M": 3, "dim": 80}])
@pytest.mark.parametrize("endpoint", ["solve", "predict"])
def test_shares_read_100_at_the_bound(cfg, endpoint):
    cfg = dict(cfg, num_domain=1000, num_boundary=200)
    rows = [64, 777, 4096]
    flops, bound_s = work.served_work(cfg, endpoint, rows)
    # the kernels take exactly the bound, and the window only them
    run = _fake_run(cfg, endpoint, rows, bound_s, bound_s, len(rows))
    assert _reader("posterior_roofline").read(run) == pytest.approx(100.0)
    assert _reader("serve_mfu").read(run) <= 100.0 + 1e-9
    assert _reader("device_idle.serve").read(run) == pytest.approx(0.0)
    # a window at the FLOP bound
    run = _fake_run(cfg, endpoint, rows, bound_s, flops / work.FP32_PEAK, len(rows))
    assert _reader("serve_mfu").read(run) == pytest.approx(100.0)


def test_train_mfu_reads_100_at_the_bound():
    cfg = {"num_domain": 1000, "num_boundary": 200, "dim": 20, "gn_steps": 20}
    window = 3 * work.train_flops(1000, 200, 21, 20) / work.FP32_PEAK
    run = types.SimpleNamespace(config=cfg, log=[],
                                tr={"ops": [], "window_s": window, "busy_s": window, "items": 3})
    assert _reader("train_mfu").read(run) == pytest.approx(100.0)
    assert _reader("device_idle.train").read(run) == pytest.approx(0.0)


def test_readers_find_nothing_without_a_trace():
    run = types.SimpleNamespace(tr=None, log=[], config={}, traffic={"endpoint": "solve"})
    for name in ("posterior_roofline", "serve_mfu", "device_ops_per_request",
                 "device_idle.serve", "device_idle.train", "train_mfu"):
        assert _reader(name).read(run) is None
