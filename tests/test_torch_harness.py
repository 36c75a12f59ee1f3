"""Port's harnesses and runner (scasml_gp_torch.harness) against the JAX
package, at D=3 on the CPU: the artifacts, metrics.json keys and log lines
of SimpleUniform and RepeatedExperiment, RunConfig's JSON, the auto-tune
policy, the posterior calls of a full-history run, the runner CLI on the
sweep harnesses and --fit-ml, and the options that are not ported yet.
(The sweeps against the JAX package: tests/test_torch_sweeps.py.)
"""

import dataclasses
import json
import os
import re
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import scasml_gp_torch as port  # noqa: E402
from scasml_gp_torch.harness import SimpleUniform  # noqa: E402
from scasml_gp_torch.harness import runner  # noqa: E402

torch.set_num_threads(2)

D = 3
SU_FILES = ["SimpleUniform.log", "metrics.json", "Error_Distribution.pdf",
            "GP_vs_SCaSML.pdf", "Relative_L2_Improvement.pdf",
            "GP_Spatiotemporal_Errors.pdf", "MLP_Spatiotemporal_Errors.pdf",
            "SCaSML_Spatiotemporal_Errors.pdf"]
RE_FILES = ["RepeatedExperiment.log", "metrics.json", "RelL2_Repetitions.pdf"]
SU_SIZES = dict(rhomax=2, num_domain=80, num_boundary=16, train_domain=60,
                train_boundary=16)
RE_SIZES = dict(rhomax=2, num_domain=60, num_boundary=12, train_domain=60,
                train_boundary=16, num_repetitions=3, M=2)


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


def _key_tree(obj):
    """Nested key structure of a metrics dict (values dropped)."""
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    return None


def _log_shape(path):
    """Log lines with every number replaced by '#'."""
    num = r"-?(\d+\.?\d*|\.\d+)(e[-+]?\d+)?|nan|inf"
    with open(path) as fh:
        return [re.sub(num, "#", line) for line in fh.read().splitlines()]


@pytest.mark.parametrize("harness,variant,files,sizes", [
    ("SimpleUniform", "quadrature", SU_FILES, SU_SIZES),
    ("RepeatedExperiment", "full_history", RE_FILES, RE_SIZES),
])
def test_harness_artifacts_keys_and_log_match_jax(tmp_path, harness, variant,
                                                  files, sizes):
    from scasml_gp_tpu import harness as jharness

    got = runner.HARNESSES[harness](*_port_solvers(variant)).test(
        str(tmp_path / "port"), **sizes)
    want = getattr(jharness, harness)(*_jax_solvers(variant)).test(
        str(tmp_path / "jax"), **sizes)
    for side in ("port", "jax"):
        for f in files:
            assert os.path.exists(tmp_path / side / harness / f), (side, f)
    with open(tmp_path / "port" / harness / "metrics.json") as fh:
        m = json.load(fh)
    with open(tmp_path / "jax" / harness / "metrics.json") as fh:
        mj = json.load(fh)
    assert _key_tree(m) == _key_tree(mj)
    assert set(got) == set(want)
    assert _log_shape(tmp_path / "port" / harness / f"{harness}.log") == \
        _log_shape(tmp_path / "jax" / harness / f"{harness}.log")
    if harness == "SimpleUniform":
        assert set(m["metrics"]) == {"GP", "MLP", "SCaSML"}
        assert got["metrics"]["SCaSML"]["rel_L2"] < 1.0
    else:
        assert m["num_repetitions"] == 3 and len(m["t_tests"]) == 9
        assert m["metrics"]["rel_L2"]["SCaSML"]["mean"] < 1.0


def test_run_config_json_round_trips_with_jax():
    """A RunConfig written by the JAX package loads unchanged, field by
    field, and the port's JSON loads in the JAX package."""
    from scasml_gp_tpu import config as jconfig

    jcfg = jconfig.RunConfig(
        dim=7, seed=5, harness="RepeatedExperiment", save_path="out",
        num_domain=123, test_boundary=17, wandb=True,
        gp=jconfig.GPConfig(ridge_scale=30.0, gamma_scale=0.3, gn_steps=9,
                            eval_chunk=512, train_backend="dense"),
        picard=jconfig.PicardConfig(variant="full_history", M=4, batch_chunk=64),
        mesh=jconfig.MeshConfig(data=1, model=1),
        precision=jconfig.PrecisionPolicy(rollout="bfloat16"),
    )
    cfg = port.RunConfig.from_json(jcfg.to_json())
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for name in ("gp", "picard", "mesh", "precision"):
        assert type(getattr(cfg, name)).__module__ == "scasml_gp_torch.config"
    assert cfg.n_input == jcfg.n_input == 8
    back = jconfig.RunConfig.from_json(cfg.to_json())
    assert back == jcfg


RESOLVE_TUNE_CASES = [
    (None, 0.0, 1.0, False, "GradDependentNonlinear"),
    (None, 0.0, 1.0, False, "AllenCahn"),
    (True, 5.0, 1.0, False, "GradDependentNonlinear"),
    (False, 0.0, 1.0, False, "GradDependentNonlinear"),
    (None, 5.0, 1.0, False, "GradDependentNonlinear"),
    (None, 0.0, 2.0, False, "GradDependentNonlinear"),
    (None, 0.0, 1.0, True, "GradDependentNonlinear"),
    (None, 0.0, 1.0, False, "HJB"),
]


@pytest.mark.parametrize("case", RESOLVE_TUNE_CASES)
def test_resolve_tune_matches_jax(case):
    from scasml_gp_tpu.harness.runner import resolve_tune as jax_resolve_tune

    assert runner.resolve_tune(*case) == jax_resolve_tune(*case)


def _small_argv(tmp_path, *extra, device="cpu"):
    return ["--dim", str(D), "--num-domain", "60", "--num-boundary", "16",
            "--test-domain", "40", "--test-boundary", "8", "--device", device,
            "--save-path", str(tmp_path), *extra]


# ids kept from when the first four cases (now in
# test_sweeps_and_fit_ml_run_through_main) and extra6, extra7 (now in
# tests/test_torch_debug_checks.py) raised too
@pytest.mark.parametrize("extra,error", [
    pytest.param(["--mesh-data", "2"], "mesh 2x1 needs 2 > 1 devices", id="extra4"),
    pytest.param(["--mesh-model", "4"], "mesh 1x4 needs 4 > 1 devices", id="extra5"),
    pytest.param(["--bf16"], None, id="extra8"),
])
def test_unported_flags_raise(tmp_path, extra, error):
    """Once unported: a mesh now raises only where it does not fit the
    world (one process here; the JAX package's message; a real mesh runs
    in tests/test_torch_mesh.py), and --bf16 runs."""
    if error is not None:
        with pytest.raises(ValueError, match=re.escape(error)):
            runner.main(_small_argv(tmp_path, *extra))
        return
    out = runner.main(_small_argv(tmp_path, "--no-tune", "--no-plots", *extra))
    assert all(np.isfinite(out["metrics"][k]["rel_L2"]) for k in ("GP", "SCaSML"))


# Tiny sizes for the sweeps, which the runner otherwise runs at their own
# defaults (1000 + 200 test points, ten training sizes, ...).
TINY_SWEEPS = {
    "ConvergenceRate": dict(n_samples=40, gn_steps=4, sizes_domain=[30, 60],
                            sizes_boundary=[8, 16]),
    "ComputingBudget": dict(budget_levels=(1,), num_domain=40, num_boundary=8,
                            train_domain=40, train_boundary=10),
    "InferenceScaling": dict(rhomax=2, n_samples=40, train_domain=40,
                             train_boundary=10, gn_steps=4),
}


@pytest.mark.parametrize("extra", [
    ["--harness", "ConvergenceRate", "--no-tune"],
    ["--harness", "ComputingBudget", "--no-tune"],
    ["--harness", "InferenceScaling", "--no-tune"],
    ["--fit-ml"],
])
def test_sweeps_and_fit_ml_run_through_main(tmp_path, monkeypatch, extra):
    """The CLI paths that once raised NotImplementedError run on the CPU and
    write their harness's metrics.json."""
    orig = runner.harness_kwargs
    monkeypatch.setattr(runner, "harness_kwargs", lambda config, **kw: dict(
        orig(config, **kw), **TINY_SWEEPS.get(config.harness, {})))
    out = runner.main(_small_argv(tmp_path, "--variant", "full_history", "--M", "2",
                                  "--no-plots", *extra))
    harness = extra[1] if extra[0] == "--harness" else "SimpleUniform"
    path = tmp_path / "GradDependentNonlinear" / f"{D}d" / "full_history" / harness
    with open(path / "metrics.json") as fh:
        m = json.load(fh)
    assert _key_tree(m) == _key_tree(out)
    rows = m["rel_L2"] if "rel_L2" in m else {k: [v["rel_L2"]] for k, v in m["metrics"].items()}
    assert {"GP", "SCaSML"} <= set(rows)
    assert all(np.isfinite(rows[k]).all() for k in rows)
    assert os.path.exists(path / f"{harness}.log")


def test_cuda_is_never_replaced_by_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where CUDA is absent")
    with pytest.raises(RuntimeError, match="CUDA"):
        runner.run(port.RunConfig(dim=D, save_path=str(tmp_path)), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        runner.main(_small_argv(tmp_path, device="cuda"))


def test_tuner_trains_on_the_harness_points(monkeypatch):
    """tuned_config hands the tuner the points the harness trains on."""
    seen = {}

    def fake_tune(gp_cls, eq, x_dom, x_bdy, base, **kw):
        seen["x"] = (x_dom, x_bdy)
        seen["grid"] = (kw["ridge_scales"], kw["gamma_scales"])
        return port.gp.tuning.TuneResult(config=base, score=0.0, table=[])

    monkeypatch.setattr(runner, "tune_gp", fake_tune)
    cfg = port.RunConfig(dim=D, num_domain=50, num_boundary=10, seed=77)
    runner.tuned_config(cfg, "cpu")
    h = SimpleUniform(*_port_solvers("full_history"))
    x_dom, x_bdy = h._train_points(50, 10, 77)
    assert torch.equal(seen["x"][0], x_dom) and torch.equal(seen["x"][1], x_bdy)
    ridges, gammas = seen["grid"]
    assert len(ridges) * len(gammas) == 20


def test_flagless_cli_tunes_and_runs_full_history(tmp_path, capsys, monkeypatch):
    """The users' path: a flagless full-history SimpleUniform run tunes the
    kernel, then runs; the posterior calls of the run are pinned (on a GPU
    each is one kernel launch): g_breve 5 (the train's and the test set's
    predict, three in the rollout), f_breve 1, leaf 3 (two in the rollout,
    the PDE loss)."""
    from scasml_gp_torch.gp.solver import GP

    out = runner.main(_small_argv(tmp_path, "--variant", "full_history",
                                  "--M", "2", "--no-plots"))
    assert "tuned GP config" in capsys.readouterr().err
    path = tmp_path / "GradDependentNonlinear" / f"{D}d" / "full_history" / "SimpleUniform"
    assert os.path.exists(path / "metrics.json") and os.path.exists(path / "SimpleUniform.log")
    assert not os.path.exists(path / "Error_Distribution.pdf")
    assert np.isfinite(out["metrics"]["SCaSML"]["rel_L2"])

    calls = {}
    orig = GP.posterior_u

    def counting(self, params, x_t, want_grad=False, want_ops=False):
        calls[(want_grad, want_ops)] = calls.get((want_grad, want_ops), 0) + 1
        return orig(self, params, x_t, want_grad, want_ops)

    monkeypatch.setattr(GP, "posterior_u", counting)
    cfg = port.RunConfig(
        dim=D, num_domain=60, num_boundary=16, test_domain=40, test_boundary=8,
        save_path=str(tmp_path / "counted"), gp=port.GPConfig(gn_steps=6),
        picard=port.PicardConfig(variant="full_history", n=2, rho=2, M=3))
    runner.run(cfg, device="cpu", make_plots=False)
    assert calls == {(False, False): 5, (True, False): 1, (False, True): 3}


def test_plots_need_matplotlib_only_to_draw(tmp_path, monkeypatch):
    """Without matplotlib the harness runs with make_plots=False (its
    hexbin_stats need none) and a plotting call raises ImportError."""
    from scasml_gp_torch.harness import plots

    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = SimpleUniform(*_port_solvers("quadrature")).test(
        str(tmp_path), **SU_SIZES, make_plots=False)
    assert set(out["diff_stats"]) == {"GP_vs_SCaSML", "MLP_vs_SCaSML"}
    with pytest.raises(ImportError):
        plots.error_bars(out["metrics"], "rel_L2", str(tmp_path / "x.pdf"))


def test_profile_dir_artifacts(tmp_path):
    """profile_dir writes the cProfile dump and a torch.profiler trace."""
    prof_dir = tmp_path / "prof"
    SimpleUniform(*_port_solvers("quadrature")).test(
        str(tmp_path), **SU_SIZES, make_plots=False, profile_dir=str(prof_dir))
    assert os.path.exists(prof_dir / "SimpleUniform_rho_2.prof")
    assert os.path.exists(prof_dir / "SimpleUniform_rho_2.trace.json")


def test_exact_solution_fallback_to_mc_reference():
    """An equation without a closed form gets the deep full-history MLP
    reference (two seeds averaged, their disagreement recorded), as in
    tests/test_harness.py: here GradDependentNonlinear with its closed form
    hidden, so the reference can be held to the exact solution (5e-2, the
    JAX test's bar at the terminal rows) and is exact at t = T."""

    class _NoClosedForm(port.GradDependentNonlinear):
        def exact_solution(self, x_t):
            raise NotImplementedError

    eq = _NoClosedForm(n_input=3)
    h = SimpleUniform(eq, port.GPGradDependentNonlinear(eq, device="cpu"), None, None)
    x_test, exact = h._test_points(24, 8, seed=0)
    assert x_test.shape == (32, 3) and exact.shape == (32, 1)
    assert np.isfinite(exact).all()
    truth = port.GradDependentNonlinear(n_input=3).exact_solution(x_test).numpy()
    np.testing.assert_allclose(exact, truth, atol=5e-2)
    np.testing.assert_allclose(exact[-8:], eq.g(x_test[-8:]).numpy(), atol=5e-2)
    assert set(h.oracle_consistency) == {"half_run_rel_disagreement",
                                         "oracle_rel_error_estimate"}
