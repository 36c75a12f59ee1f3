"""Port's four sweep harnesses (ConvergenceRate, InferenceScaling,
SimpleScaling, ComputingBudget) and the runner's keyword selection against
the JAX package, at D=3 on the CPU, at the sizes of tests/test_harness.py.

Both harnesses are fed the same numpy training and test points (the JAX
package's draws), and the port's Newton trains start from the JAX trainer's
initial point, so the GP rows are the same trained surrogate on both sides:
they agree within GP_REL, the bar tests/test_torch_tuning.py sets for
trained weights.  MLP and ScaSML rows are Monte-Carlo estimates from
different generators; they are checked finite, and every derived number
(slopes, improvement_pct) is recomputed from the port's own rows.
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

import scasml_gp_torch as port  # noqa: E402
from scasml_gp_torch.harness import runner  # noqa: E402
from scasml_gp_torch.harness.base import HarnessBase  # noqa: E402
from scasml_gp_torch.picard.mlp import _PicardBase  # noqa: E402

torch.set_num_threads(2)

D = 3
GP_REL = 1e-2
SWEEPS = {
    # harness: (variant, test() sizes, files besides metrics.json)
    "ConvergenceRate": ("full_history", dict(
        M=2, n_samples=60, gn_steps=6, sizes_domain=[40, 80, 120],
        sizes_boundary=[8, 16, 24]), ["ConvergenceRate.log", "ConvergenceRate.pdf"]),
    "InferenceScaling": ("full_history", dict(
        M=2, rhomax=2, n_samples=60, train_domain=60, train_boundary=16, gn_steps=6),
        ["InferenceScaling.log", "InferenceScaling_Improvement.pdf"]),
    "SimpleScaling": ("full_history", dict(
        max_base=3, n_samples=60, train_domain=60, train_boundary=16, gn_steps=6),
        ["SimpleScaling.log", "SimpleScaling_Improvement.pdf"]),
    "ComputingBudget": ("full_history", dict(
        M=2, budget_levels=(1, 2), num_domain=60, num_boundary=12, train_domain=60,
        train_boundary=16), ["ComputingBudget.log", "ComputingBudget_Errors.pdf",
                             "Improvement_Bar_Chart.pdf"]),
}


def _port_solvers(variant):
    eq = port.GradDependentNonlinear(n_input=D + 1)
    gp = port.GPGradDependentNonlinear(eq, port.GPConfig(gn_steps=6), device="cpu")
    if variant == "full_history":
        return eq, gp, port.MLPFullHistory(eq, device="cpu"), port.ScaSMLFullHistory(eq, gp)
    return eq, gp, port.MLP(eq, device="cpu"), port.ScaSML(eq, gp)


def _jax_solvers(variant):
    from scasml_gp_tpu import picard
    from scasml_gp_tpu.config import GPConfig
    from scasml_gp_tpu.equations import GradDependentNonlinear
    from scasml_gp_tpu.gp import GPGradDependentNonlinear

    eq = GradDependentNonlinear(n_input=D + 1)
    gp = GPGradDependentNonlinear(eq, GPConfig(gn_steps=6))
    if variant == "full_history":
        return eq, gp, picard.MLPFullHistory(eq), picard.ScaSMLFullHistory(eq, gp)
    return eq, gp, picard.MLP(eq), picard.ScaSML(eq, gp)


def _same_inputs(mp):
    """Patch, through the MonkeyPatch ``mp``, the port's harnesses to draw
    the JAX package's training and test points, and its Newton trains to
    start from the JAX trainer's initial point."""
    from scasml_gp_tpu.harness.base import HarnessBase as JaxHarnessBase

    jax_eq = _jax_solvers("quadrature")[0]

    def train_points(self, num_domain, num_boundary, seed):
        x_dom, x_bdy = jax_eq.generate_data(num_domain, num_boundary,
                                            key=jax.random.PRNGKey(seed))
        return torch.from_numpy(np.array(x_dom)), torch.from_numpy(np.array(x_bdy))

    def test_points(self, num_domain, num_boundary, seed):
        x_test, exact = JaxHarnessBase(jax_eq, None, None, None)._test_points(
            num_domain, num_boundary, seed)
        return torch.from_numpy(np.array(x_test)), exact

    orig_train = port.GP._train

    def train(self, x_dom, x_bdy, bdy_g, rhs, gamma, nugget, steps, damping,
              grad_tol, sol0=None):
        if sol0 is None:
            sol0 = torch.from_numpy(np.array(
                jax.random.normal(jax.random.PRNGKey(0), (3 * x_dom.shape[0],))
                * self.config.init_scale, np.float32))
        return orig_train(self, x_dom, x_bdy, bdy_g, rhs, gamma, nugget, steps,
                          damping, grad_tol, sol0)

    mp.setattr(HarnessBase, "_train_points", train_points)
    mp.setattr(HarnessBase, "_test_points", test_points)
    mp.setattr(port.GP, "_train", train)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """run(harness) -> (port result, JAX result, output dir): each harness
    runs once on each side, on the same inputs."""
    from scasml_gp_tpu import harness as jharness

    done = {}

    def run(harness):
        if harness not in done:
            variant, sizes, _ = SWEEPS[harness]
            out = tmp_path_factory.mktemp(harness)
            with pytest.MonkeyPatch.context() as mp:
                _same_inputs(mp)
                got = runner.HARNESSES[harness](*_port_solvers(variant)).test(
                    str(out / "port"), **sizes)
                want = getattr(jharness, harness)(*_jax_solvers(variant)).test(
                    str(out / "jax"), **sizes)
            done[harness] = (got, want, out)
        return done[harness]

    return run


def _key_tree(obj):
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    return None


def _log_shape(path):
    """Log lines with every number replaced by '#'."""
    num = r"-?(\d+\.?\d*|\.\d+)(e[-+]?\d+)?|nan|inf"
    with open(path) as fh:
        return [re.sub(num, "#", line) for line in fh.read().splitlines()]


@pytest.mark.parametrize("harness", sorted(SWEEPS))
def test_sweep_artifacts_keys_and_log_match_jax(runs, harness):
    got, want, tmp_path = runs(harness)
    for side in ("port", "jax"):
        for f in ["metrics.json"] + SWEEPS[harness][2]:
            assert os.path.exists(tmp_path / side / harness / f), (side, f)
    with open(tmp_path / "port" / harness / "metrics.json") as fh:
        m = json.load(fh)
    with open(tmp_path / "jax" / harness / "metrics.json") as fh:
        mj = json.load(fh)
    assert _key_tree(m) == _key_tree(mj)
    assert _key_tree(got) == _key_tree(want)
    assert _log_shape(tmp_path / "port" / harness / f"{harness}.log") == \
        _log_shape(tmp_path / "jax" / harness / f"{harness}.log")
    for name, rows in got["rel_L2"].items():
        assert len(rows) == len(want["rel_L2"][name])
        assert np.all(np.isfinite(rows)), name
    np.testing.assert_allclose(got["rel_L2"]["GP"], want["rel_L2"]["GP"], rtol=GP_REL)


def test_convergence_rate_rows_and_slopes(runs):
    got, want, _ = runs("ConvergenceRate")
    assert got["train_sizes"] == want["train_sizes"] == [48, 96, 144]
    eps = 1e-10
    logx = np.log10(np.asarray(got["train_sizes"]) + eps)
    for name in ("GP", "SCaSML"):
        slope, _ = np.polyfit(logx, np.log10(np.asarray(got["rel_L2"][name]) + eps), 1)
        assert got["slopes"][name] == float(slope)
    np.testing.assert_allclose(got["slopes"]["GP"], want["slopes"]["GP"],
                               atol=GP_REL)


@pytest.mark.parametrize("harness", ["InferenceScaling", "SimpleScaling"])
def test_scaling_counters_and_improvement(runs, harness):
    got, want, _ = runs(harness)
    assert got["evaluation_counter"] == want["evaluation_counter"]
    axis = "rho" if harness == "InferenceScaling" else "sample_base"
    assert got[axis] == want[axis]
    e = {k: np.asarray(v) for k, v in got["rel_L2"].items()}
    emin = np.minimum(e["GP"], e["MLP"])
    assert got["improvement_pct"] == ((emin - e["SCaSML"]) / emin * 100.0).tolist()


def test_computing_budget_builds_fresh_solvers_on_the_callers_device(
        tmp_path, monkeypatch):
    """Each level builds a GP, an MLP, a GP for ScaSML and ScaSML, all on
    the originals' device (the CPU here: a solver built without a device
    would ask for CUDA)."""
    devices = []
    for cls in (port.GP, _PicardBase):
        orig = cls.__init__

        def init(self, *a, _orig=orig, **kw):
            _orig(self, *a, **kw)
            devices.append((type(self).__name__, self.device))

        monkeypatch.setattr(cls, "__init__", init)
    solvers = _port_solvers("full_history")
    devices.clear()
    _, sizes, _ = SWEEPS["ComputingBudget"]
    out = runner.HARNESSES["ComputingBudget"](*solvers).test(
        str(tmp_path), make_plots=False, **sizes)
    assert sorted(n for n, _ in devices) == sorted(
        ["GPGradDependentNonlinear", "MLPFullHistory", "GPGradDependentNonlinear",
         "ScaSMLFullHistory"] * 2)
    assert all(d == torch.device("cpu") for _, d in devices)
    assert out["budget_levels"] == [1, 2]
    assert all(t > 0 for ts in out["times"].values() for t in ts)


@pytest.mark.parametrize("variant", ["quadrature", "full_history"])
@pytest.mark.parametrize("harness", sorted(runner.HARNESSES))
def test_harness_kwargs_match_jax_run(tmp_path, monkeypatch, harness, variant):
    """runner.harness_kwargs selects what the JAX runner's run() passes to
    each harness's test(); run() hands them on unchanged."""
    from scasml_gp_tpu import config as jconfig
    from scasml_gp_tpu.harness import runner as jrunner

    seen = {}

    def stub(side):
        class Stub:
            def __init__(self, *a, **kw):
                pass

            def test(self, save_path, **kw):
                seen[side] = kw
        return Stub

    monkeypatch.setitem(jrunner.HARNESSES, harness, stub("jax"))
    monkeypatch.setitem(runner.HARNESSES, harness, stub("port"))
    fields = dict(dim=D, harness=harness, save_path=str(tmp_path), seed=7,
                  num_domain=50, num_boundary=10, test_domain=30, test_boundary=6)
    pic = dict(variant=variant, rho=3, M=4)
    jrunner.run(jconfig.RunConfig(**fields, picard=jconfig.PicardConfig(**pic)))
    cfg = port.RunConfig(**fields, picard=port.PicardConfig(**pic))
    runner.run(cfg, device="cpu")
    assert seen["port"] == seen["jax"] == runner.harness_kwargs(cfg)
    assert runner.harness_kwargs(cfg, make_plots=False) == dict(
        seen["jax"], make_plots=False)
    assert dataclasses.asdict(cfg.picard) == dataclasses.asdict(
        jconfig.PicardConfig(**pic))
