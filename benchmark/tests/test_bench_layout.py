"""The benchmark's layout: nothing it runs loads JAX or the JAX package,
the reference loads nothing of the port, a new configuration, mix and
metric are found as new files alone, and the traffic is fixed by the
seed."""

import ast
import glob
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

from benchmark import traffic
from conftest import ROOT, run_cpu

FORBIDDEN = {"jax", "jaxlib", "flax", "scasml_gp_tpu"}


def _top_level_modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tiny_root):
    code = ("import contextlib, io\nfrom benchmark import run\n"
            "with contextlib.redirect_stdout(io.StringIO()):\n"
            f"    assert run.main(['--workload', 'gdn20_quad.solve_testset', '--seed', '3',"
            f" '--seconds', '0.5'], root={tiny_root!r}, device='cpu') == 0\n")
    mods = _top_level_modules_after(code)
    assert "scasml_gp_torch" in mods
    assert not mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    mods = _top_level_modules_after(
        "import benchmark.reference.gp, benchmark.reference.picard, benchmark.work")
    assert not mods & (FORBIDDEN | {"scasml_gp_torch"})
    for path in glob.glob(os.path.join(ROOT, "benchmark", "reference", "*.py")):
        with open(path) as fh:
            tree = ast.parse(fh.read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert not {m.split(".")[0] for m in names} & (FORBIDDEN | {"scasml_gp_torch"}), path


def _digests(root):
    return {p: hashlib.sha256(open(p, "rb").read()).hexdigest()
            for p in glob.glob(os.path.join(root, "benchmark", "**", "*"), recursive=True)
            if os.path.isfile(p)}


def test_new_config_mix_and_metric_are_new_files_only(tiny_root):
    before = _digests(tiny_root)
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    b = os.path.join(tiny_root, "benchmark")
    with open(os.path.join(b, "configs", "gdn20_quad.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="gdn5_fh", dim=5, solver="full_history", n=1, M=4)
    with open(os.path.join(b, "configs", "gdn5_fh.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(b, "traffic", "solve_testset.json")) as fh:
        mix = json.load(fh)
    mix.update(test_domain=20, test_boundary=6, test_sets=2)
    with open(os.path.join(b, "traffic", "solve_small.json"), "w") as fh:
        json.dump(mix, fh)
    with open(os.path.join(b, "metrics", "requests_per_s.py"), "w") as fh:
        fh.write("def read(run):\n    return len(run.log) / run.window_s\n")
    with open(os.path.join(b, "limits", "gdn5_fh.solve_small.json"), "w") as fh:
        json.dump({"train_gap": 0.02, "solve_gap": 0.02}, fh)
    spec["configs"].append({"name": "gdn5_fh", "source": "test", "file":
                            "benchmark/configs/gdn5_fh.json", "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "gdn5_fh.solve_small", "config": "gdn5_fh",
                              "traffic": "solve_small", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "requests_per_s", "unit": "1/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["gdn5_fh.solve_small"]})
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    rc, res = run_cpu(tiny_root, "gdn5_fh.solve_small")
    assert rc == 0 and res["correct"], res
    assert set(res["metrics"]) == {"setup_s", "requests_per_s"}
    assert res["attempted"] > 0
    after = _digests(tiny_root)
    assert all(after[p] == h for p, h in before.items())


def test_traffic_is_fixed_by_the_seed():
    with open(os.path.join(ROOT, "benchmark", "traffic", "solve_testset.json")) as fh:
        mix = json.load(fh)
    mix.update(test_sets=8)
    a, b = (traffic.Requests(mix, 2**31 + 17, 20, 0.5, 0.0, 0.5) for _ in range(2))
    c = traffic.Requests(mix, 5, 20, 0.5, 0.0, 0.5)
    n = 2 * len(a.pool) + 3
    assert all(np.array_equal(a.points(i), b.points(i)) for i in range(n))
    assert not np.array_equal(a.pool, c.pool)
    # every request is one test set: its interior points, then its boundary
    # points, each on a face of the lateral boundary
    n_dom, n_bdy = mix["test_domain"], mix["test_boundary"]
    for i in range(n):
        x = a.points(i)
        assert x.shape == (n_dom + n_bdy, 21) and x.dtype == np.float32
        assert np.all(np.abs(x[:, :-1]) <= 0.5) and np.all((x[:, -1] >= 0) & (x[:, -1] < 0.5))
        assert np.all(np.abs(x[:n_dom, :-1]).max(1) < 0.5)
        assert np.all(np.abs(x[n_dom:, :-1]).max(1) == 0.5)
    # each cycle sends every test set of the pool once, in its own order
    k = len(a.pool)
    ids = [[next(j for j in range(k) if np.array_equal(a.points(i), a.pool[j]))
            for i in range(r * k, (r + 1) * k)] for r in range(2)]
    assert sorted(ids[0]) == sorted(ids[1]) == list(range(k)) and ids[0] != ids[1]
    assert traffic.train_candidates({"ridge_scales": [0, 1], "gamma_scales": [1, 2]}, 9) == \
        traffic.train_candidates({"ridge_scales": [0, 1], "gamma_scales": [1, 2]}, 9)
