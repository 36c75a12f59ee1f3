"""The port's experiment drivers (scasml_gp_torch.scripts) against the JAX
package's (scripts/), on the CPU at small sizes.

- run_all: both drivers run with the same flags, with ``run``, ``tune_gp``
  and ``fit_gp_marginal_likelihood`` replaced by recording stubs in each, so
  the campaign's bookkeeping is compared and nothing trains: the rows and
  their order, each row's RunConfig (``to_json``), the tune grid, one tune
  per (equation, dim), and ``--fit-ml``'s seed (the 20-candidate grid's
  winner).  The summary helpers and summarize_campaign give the JAX
  functions' outputs on the same inputs.
- throughput: the JSON keys and ``evals_per_call`` at d=3, batch 16; the
  sharded leg on a gloo world of 2 processes (torchrun's environment)
  against the JAX script on the test session's 8 virtual devices.
- high_dim: the grad_dep leg at d=3 on the JAX package's points (the port's
  point draws patched to return them, its Newton trains started from the
  JAX trainer's initial point): the GP rel-L2 within GP_REL, the bar of
  tests/test_torch_sweeps.py for one trained surrogate on both sides; MLP
  and ScaSML are Monte-Carlo estimates from other generators, so finite.
  The GP the leg hands back (``keep``) is the one it measured.
- stretch_d250: the mesh leg, sharded against unsharded HJB ScaSML on a
  gloo world of 4 CPU processes at d=8, within the 'data' axis's rtol 1e-4,
  atol 1e-5 (tests/test_sharding.py).
"""

import contextlib
import dataclasses
import io
import json
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

import scasml_gp_torch as port  # noqa: E402
from scasml_gp_torch.scripts import high_dim, run_all, stretch_d250  # noqa: E402
from scasml_gp_torch.scripts import summarize_campaign, throughput  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GP_REL = 1e-2
CAMPAIGN_ARGV = [
    "--dims", "3", "4", "--variants", "quadrature", "full_history",
    "--equations", "GradDependentNonlinear", "HJB", "SineNonlinear",
    "--harnesses", "RepeatedExperiment", "SimpleScaling",
    "--num-domain", "40", "--num-boundary", "8",
]
TUNED_PAIRS = {(e, d) for e in ("GradDependentNonlinear", "SineNonlinear")
               for d in (3, 4)}


def _campaign(mp, module, calls, argv):
    """Patch ``module``'s (a run_all module's) entry points with recording stubs,
    through the MonkeyPatch ``mp``, and run its main(argv).  ``module`` is
    the port's driver or the JAX package's modules that its driver imports
    from when it runs."""

    def tune(gp_cls, equation, x_dom, x_bdy, base=None, ridge_scales=None,
             gamma_scales=None, **kw):
        calls["tune"].append(dict(
            gp=gp_cls.__name__, dim=equation.n_input - 1,
            points=(int(x_dom.shape[0]), int(x_bdy.shape[0])),
            base=dataclasses.asdict(base), ridge=[float(r) for r in ridge_scales],
            gamma=[float(g) for g in gamma_scales], kw=sorted(kw)))
        return types.SimpleNamespace(config=dataclasses.replace(
            base, ridge_scale=100.0, gamma_scale=0.3 + 0.01 * equation.n_input))

    def fit(gp_cls, equation, x_dom, x_bdy, base=None, seed_configs=(), **kw):
        calls["fit"].append(dict(
            gp=gp_cls.__name__, dim=equation.n_input - 1,
            base=dataclasses.asdict(base),
            seeds=[dataclasses.asdict(c) for c in seed_configs], kw=sorted(kw)))
        return types.SimpleNamespace(config=dataclasses.replace(
            seed_configs[0], time_scale=0.7))

    def run(config, **kw):
        # the two sides save into their own directories
        assert config.save_path == argv[argv.index("--save-path") + 1]
        calls["run"].append(dataclasses.replace(config, save_path="<save>").to_json())
        if config.equation == "HJB" and config.picard.variant == "quadrature":
            raise ValueError("a bad row")
        v = 0.01 * config.dim
        return {"metrics": {"rel_L2": {s: {"mean": v + i, "std": 0.0}
                                       for i, s in enumerate(("GP", "MLP", "SCaSML"))}}}

    tune_mod, fit_mod, run_mod = module
    mp.setattr(tune_mod, "tune_gp", tune)
    mp.setattr(fit_mod, "fit_gp_marginal_likelihood", fit)
    mp.setattr(run_mod, "run", run)


@pytest.fixture(scope="module", params=["tuned", "--fit-ml", "--no-tune"])
def campaigns(request, tmp_path_factory):
    """(port calls, JAX calls, port summary, JAX summary) of one campaign."""
    import scasml_gp_tpu.gp.marginal as jmarginal
    import scasml_gp_tpu.gp.tuning as jtuning
    import scasml_gp_tpu.harness.runner as jrunner
    from scripts import run_all as jax_run_all

    flags = [] if request.param == "tuned" else [request.param]
    out = {}
    for side in ("port", "jax"):
        save = tmp_path_factory.mktemp(side)
        calls = {"tune": [], "fit": [], "run": []}
        argv = CAMPAIGN_ARGV + flags + ["--save-path", str(save)]
        with pytest.MonkeyPatch.context() as mp:
            if side == "port":
                _campaign(mp, (run_all,) * 3, calls, argv)
                run_all.main(argv + ["--device", "cpu", "--no-plots"])
            else:
                _campaign(mp, (jtuning, jmarginal, jrunner), calls, argv)
                jax_run_all.main(argv)
        with open(save / "run_all_summary.json") as fh:
            out[side] = (calls, json.load(fh))
    return request.param, out["port"], out["jax"]


def test_run_all_rows_and_configs_match_jax(campaigns):
    _, (got, got_summary), (want, want_summary) = campaigns
    rows = [json.loads(c) for c in got["run"]]
    tags = [f"{r['equation']}/{r['dim']}d/{r['picard']['variant']}/{r['harness']}"
            for r in rows]
    assert len(tags) == 3 * 2 * 3  # SimpleScaling has no quadrature row
    assert "GradDependentNonlinear/3d/quadrature/SimpleScaling" not in tags
    assert got["run"] == want["run"]
    assert list(got_summary) == list(want_summary) == tags
    strip = {k: {f: v for f, v in row.items() if f != "wall_s"}
             for k, row in got_summary.items()}
    assert strip == {k: {f: v for f, v in row.items() if f != "wall_s"}
                     for k, row in want_summary.items()}
    errors = {k: row for k, row in strip.items() if "error" in row}
    assert errors == {f"HJB/{d}d/quadrature/RepeatedExperiment":
                      {"error": "ValueError: a bad row"} for d in (3, 4)}


def test_run_all_tunes_once_per_equation_and_dim(campaigns):
    mode, (got, _), (want, _) = campaigns
    assert got["tune"] == want["tune"]
    if mode == "--no-tune":
        assert got["tune"] == [] and got["fit"] == []
        assert all(json.loads(c)["gp"]["ridge_scale"] == 0.0 for c in got["run"])
        return
    pairs = [(c["gp"], c["dim"]) for c in got["tune"]]
    assert len(pairs) == len(set(pairs)) == len(TUNED_PAIRS)
    assert {("GradDependentNonlinear" if "Grad" in g else "SineNonlinear", d)
            for g, d in pairs} == TUNED_PAIRS
    for call in got["tune"]:
        assert call["ridge"] == list(port.harness.runner.TUNE_RIDGE_SCALES)
        assert call["ridge"] == [0.0, 10.0, 30.0, 100.0, 300.0]
        assert call["gamma"] == [1.0, 0.3, 0.1, 0.05]
        assert call["points"] == (40, 8) and call["kw"] == []
    # every row of a tuned (equation, dim) runs with the tune's (or fit's)
    # kernel; HJB rows keep the default
    for c in got["run"]:
        row = json.loads(c)
        tuned = (row["equation"], row["dim"]) in TUNED_PAIRS
        assert row["gp"]["ridge_scale"] == (100.0 if tuned else 0.0)
        assert row["gp"]["time_scale"] == (0.7 if tuned and mode == "--fit-ml" else 1.0)


def test_run_all_fit_ml_seeds_the_fit_with_the_grid_winner(campaigns):
    mode, (got, _), (want, _) = campaigns
    assert got["fit"] == want["fit"]
    if mode != "--fit-ml":
        assert got["fit"] == []
        return
    assert len(got["fit"]) == len(got["tune"]) == len(TUNED_PAIRS)
    for tune, fit in zip(got["tune"], got["fit"]):
        winner = dict(tune["base"], ridge_scale=100.0,
                      gamma_scale=0.3 + 0.01 * (tune["dim"] + 1))
        assert fit["seeds"] == [winner]  # the 20-candidate grid's winner
        assert (fit["gp"], fit["dim"], fit["kw"]) == (tune["gp"], tune["dim"], [])


HEADLINE_RESULTS = {
    "repeated": {"num_repetitions": 10, "metrics": {"rel_L2": {
        "GP": {"mean": 0.02, "std": 0.001}, "MLP": {"mean": 0.15, "std": 0.01},
        "SCaSML": {"mean": 0.013, "std": 0.001}}, "L1": {}}},
    "simple_uniform": {"metrics": {s: {"L1": 0.1, "L2": 0.2, "rel_L2": v}
                                   for s, v in (("GP", 0.03), ("MLP", 0.2),
                                                ("SCaSML", 0.01))}},
    "sweep": {"train_sizes": [48, 96], "rel_L2": {"GP": [0.1, 0.05],
                                                  "SCaSML": [0.05, 0.02]}},
    "no_rel": {"raw": 1, "slopes": {"GP": -1.0}, "a": 2, "b": 3, "c": 4},
    "not_a_dict": [0.1, 0.2],
}


@pytest.mark.parametrize("shape", sorted(HEADLINE_RESULTS))
def test_headline_matches_jax(shape):
    from scripts import run_all as jax_run_all

    result = HEADLINE_RESULTS[shape]
    assert run_all._headline(result) == jax_run_all._headline(result)


@pytest.mark.parametrize("existing", ["legacy", "corrupt", "none"])
def test_write_summary_merges_like_jax(tmp_path, existing):
    from scripts import run_all as jax_run_all

    rows = {"GradDependentNonlinear/20d/full_history/RepeatedExperiment":
            {"wall_s": 1.0, "metrics": {"rel_L2": {"GP": 0.5}}},
            "HJB/20d/quadrature/RepeatedExperiment": {"error": "ValueError: x"}}
    before = {"20d/quadrature": {"metrics": {"rel_L2": {"GP": 0.1}}},
              "GradDependentNonlinear/20d/full_history/RepeatedExperiment":
              {"metrics": {"rel_L2": {"GP": 0.9}}},
              "SineNonlinear/100d/full_history/SimpleUniform": {"wall_s": 3.0}}
    outs = []
    for side, fn in (("port", run_all._write_summary),
                     ("jax", jax_run_all._write_summary)):
        path = tmp_path / side
        path.mkdir()
        if existing == "legacy":
            (path / "run_all_summary.json").write_text(json.dumps(before))
        elif existing == "corrupt":
            (path / "run_all_summary.json").write_text("{not json")
        fn(str(path), rows)
        outs.append((path / "run_all_summary.json").read_text())
    assert outs[0] == outs[1]
    merged = json.loads(outs[0])
    if existing == "legacy":
        assert "GradDependentNonlinear/20d/quadrature/RepeatedExperiment" in merged
        assert merged["GradDependentNonlinear/20d/full_history/RepeatedExperiment"] == \
            rows["GradDependentNonlinear/20d/full_history/RepeatedExperiment"]
        assert len(merged) == 4
    else:
        assert merged == rows


SUMMARIES = ["reports/campaign", "reports/campaign_ml", "reports/campaign_largeN",
             "synthetic"]


@pytest.mark.parametrize("source", SUMMARIES)
def test_summarize_campaign_prints_the_jax_tables(tmp_path, capsys, monkeypatch, source):
    from scripts import summarize_campaign as jax_summarize

    if source == "synthetic":
        summary = {"HJB/20d/quadrature/RepeatedExperiment": {"error": "E: x"},
                   "20d/quadrature": {"metrics": {"rel_L2": {"GP": 0.1}}},
                   "Sine/20d/full_history/ComputingBudget": {"metrics": {"rel_L2": {
                       "GP": [0.2, 0.1], "MLP": [], "SCaSML": 0.05}}},
                   "GradDependentNonlinear/20d/full_history/RepeatedExperiment": {
                       "metrics": {"rel_L2": {"GP": 0.02, "MLP": 1, "SCaSML": 0.01}}}}
        save = tmp_path
        (save / "run_all_summary.json").write_text(json.dumps(summary))
    else:
        save = os.path.join(REPO, source)
    monkeypatch.setattr(sys, "argv", ["summarize_campaign.py", "--save-path", str(save)])
    jax_summarize.main()
    want = capsys.readouterr().out
    text = summarize_campaign.main(["--save-path", str(save)])
    got = capsys.readouterr().out
    assert got == want and got == text + "\n"
    assert "| equation | d | variant | GP | MLP | SCaSML |" in got


THROUGHPUT_ARGV = ["--d", "3", "--batch", "16", "--reps", "1"]


@pytest.fixture(scope="module")
def jax_throughput():
    """The JAX script's JSON on one device and on the session's 8 virtual
    CPU devices (its sharded leg)."""
    from scripts import throughput as jax_throughput

    outs = {}
    devices = jax.devices
    with pytest.MonkeyPatch.context() as mp:
        for name, devs in (("one", lambda: devices()[:1]), ("all", devices)):
            mp.setattr(sys, "argv", ["throughput.py"] + THROUGHPUT_ARGV)
            mp.setattr(jax, "devices", devs)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                jax_throughput.main()
            outs[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
    return outs


def test_throughput_keys_and_evaluations_match_jax(jax_throughput, capsys):
    got = throughput.main(THROUGHPUT_ARGV + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = jax_throughput["one"]
    assert printed == got
    assert list(got) == list(want)
    for k in ("d", "batch", "n", "M", "evals_per_call"):
        assert got[k] == want[k], k
    assert got["evals_per_call"] == 239  # count_evaluations_full_history(3, 4)
    assert got["single_device_s"] > 0
    assert got["gsamples_per_sec_per_device"] == pytest.approx(
        239 * 16 / got["single_device_s"] / 1e9)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_throughput_sharded_leg_under_torchrun_env(jax_throughput):
    """Two processes with torchrun's environment (gloo on the CPU): rank 0
    prints the JAX script's sharded keys."""
    env = dict(os.environ, PYTHONPATH=REPO, WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "scasml_gp_torch.scripts.throughput", *THROUGHPUT_ARGV,
         "--device", "cpu"], cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[1][0].strip() == ""  # rank 1 prints nothing
    got = json.loads(outs[0][0].strip().splitlines()[-1])
    want = jax_throughput["all"]
    assert list(got) == list(want)
    assert got["n_devices"] == 2 and want["n_devices"] == 8
    assert got["evals_per_call"] == want["evals_per_call"]
    assert got["sharded_s"] > 0 and got["scaling_efficiency"] > 0


HIGH_DIM = dict(d=3, n_test=40, n_train=60, n_bdy=16, gn_steps=6)


@pytest.fixture(scope="module")
def grad_dep_runs():
    """The grad_dep leg of both drivers on the JAX package's points."""
    from scasml_gp_tpu.equations import GradDependentNonlinear as JaxEq
    from scripts import high_dim as jax_high_dim

    h = HIGH_DIM
    want = jax_high_dim.run_grad_dep(h["d"], False, h["n_test"], h["n_train"],
                                     h["n_bdy"], h["gn_steps"])
    jax_eq = JaxEq(n_input=h["d"] + 1)

    def generate_data(self, num_domain, num_boundary, gen, device=None, dtype=None):
        x = jax_eq.generate_data(num_domain, num_boundary, key=jax.random.PRNGKey(1234))
        return tuple(torch.from_numpy(np.array(a)) for a in x)

    def generate_test_data(self, num_domain, num_boundary, gen, device=None,
                           dtype=None):
        x = jax_eq.generate_test_data(num_domain, num_boundary,
                                      key=jax.random.PRNGKey(42))
        return tuple(torch.from_numpy(np.array(a)) for a in x)

    orig_train = port.GP._train

    def train(self, x_dom, x_bdy, bdy_g, rhs, gamma, nugget, steps, damping,
              grad_tol, sol0=None):
        if sol0 is None:
            sol0 = torch.from_numpy(np.array(
                jax.random.normal(jax.random.PRNGKey(0), (3 * x_dom.shape[0],))
                * self.config.init_scale, np.float32))
        return orig_train(self, x_dom, x_bdy, bdy_g, rhs, gamma, nugget, steps,
                          damping, grad_tol, sol0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port.GradDependentNonlinear, "generate_data", generate_data)
        mp.setattr(port.GradDependentNonlinear, "generate_test_data",
                   generate_test_data)
        mp.setattr(port.GP, "_train", train)
        keep = {}
        got = high_dim.run_grad_dep(h["d"], False, h["n_test"], h["n_train"],
                                    h["n_bdy"], h["gn_steps"], device="cpu", keep=keep)
        eq = keep["gp"].equation
        x_test = torch.cat(eq.generate_test_data(h["n_test"], h["n_test"] // 5, None))
        kept_rel = high_dim.rel_l2(keep["gp"].predict(x_test), eq.exact_solution(x_test))
    return got, want, kept_rel


def _key_tree(obj):
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    return None


def test_high_dim_grad_dep_matches_jax(grad_dep_runs):
    got, want, _ = grad_dep_runs
    assert _key_tree(got) == _key_tree(want)
    for k in ("equation", "d", "fit_ml", "gp_config", "n_test"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["rel_L2"]["GP"], want["rel_L2"]["GP"], rtol=GP_REL)
    assert all(np.isfinite(v) for v in got["rel_L2"].values())
    assert all(v >= 0 for v in got["wall_s"].values())


def test_high_dim_keeps_the_gp_it_ran(grad_dep_runs):
    """``keep`` receives the leg's own GP: its prediction at the leg's test
    points gives the leg's GP rel-L2."""
    got, _, kept_rel = grad_dep_runs
    assert kept_rel == got["rel_L2"]["GP"]


@pytest.mark.parametrize("equation", ["allen_cahn", "hjb"])
def test_high_dim_cli_writes_the_jax_keys(tmp_path, capsys, equation):
    """The other two legs through the CLI at d=3 and tiny sizes: the JAX
    script's keys (read from its return statements), finite errors, and the
    JSON file named as the JAX script names it."""
    result = high_dim.main(["--equation", equation, "--dim", "3", "--n-test", "40",
                            "--train-size", "60", "--gn-steps", "6", "--device", "cpu",
                            "--out", str(tmp_path)])
    with open(tmp_path / f"{equation}_d3.json") as fh:
        assert json.load(fh) == result
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result
    if equation == "hjb":
        runs = ["n1_M8", "n2_M12", "n3_M16"]
        assert _key_tree(result) == {"equation": None, "d": None,
                                     "rel_L2_vs_cole_hopf": dict.fromkeys(runs),
                                     "wall_s": dict.fromkeys(runs)}
        errs = result["rel_L2_vs_cole_hopf"].values()
    else:
        assert _key_tree(result) == {
            "equation": None, "d": None, "fit_ml": None,
            "rel_vs_mc_reference": {"GP": None, "SCaSML": None},
            "wall_s": {"gp_train": None}, "n_test": None, "note": None}
        errs = result["rel_vs_mc_reference"].values()
    assert all(np.isfinite(v) and v >= 0 for v in errs)


def test_stretch_mesh_leg_on_gloo_ranks(tmp_path):
    summary = stretch_d250.leg_mesh_check("cpu", ranks=4, d=8, out_dir=str(tmp_path))
    with open(tmp_path / "mesh_check.json") as fh:
        assert json.load(fh) == summary
    with open(os.path.join(REPO, "reports/d250_stretch/mesh_check.json")) as fh:
        jax_keys = list(json.load(fh))
    assert list(summary) == jax_keys + ["within_data_tolerance"]
    assert summary["mesh"] == "4x1 (data, model)" and summary["batch"] == 32
    assert summary["within_data_tolerance"] and summary["agree"]
    assert summary["max_abs_diff"] <= 1e-5 + 1e-4 * summary["u_scale"]
    assert np.isfinite(summary["u_scale"]) and summary["u_scale"] > 0


def test_drivers_default_to_the_card(monkeypatch, tmp_path):
    """--device defaults to cuda and raises without it, before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((run_all.main, ["--save-path", str(tmp_path)]),
                       (throughput.main, []), (high_dim.main, ["--out", str(tmp_path)]),
                       (stretch_d250.main, []), (stretch_d250.main, ["--tpu"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    assert not os.path.exists(tmp_path / "run_all_summary.json")
