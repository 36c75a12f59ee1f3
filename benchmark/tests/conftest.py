"""Fixtures of the benchmark's own tests: the repository on ``sys.path``,
few threads, and a copy of the benchmark with cells cut to a size the CPU
runs in seconds."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

torch.set_num_threads(2)

# the cells' sizes on the CPU: widths, points and requests cut, the rest as
# in the committed files
TINY_CONFIG = {"gdn20_quad": {"dim": 3}, "gdn80_fh": {"dim": 4}}
TINY = {"num_domain": 40, "num_boundary": 10, "buckets": [16, 64]}
TINY_SERVE = {"test_domain": 10, "test_boundary": 3, "test_sets": 4, "warmup_requests": 4,
              "check_requests": 3}
TINY_TRAIN = {"ridge_scales": [0.0, 10.0], "gamma_scales": [1.0, 0.3]}
# the numbers a sound tiny run reads lie near 1e-3
TINY_LIMIT = 2e-2


def make_tiny_root(dest: str) -> str:
    """A directory with the benchmark's files and BENCHMARK.json, every cell
    cut to the CPU's size, every limit TINY_LIMIT."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    for c in spec["configs"]:
        path = os.path.join(dest, c["file"])
        with open(path) as fh:
            cfg = json.load(fh)
        cfg.update(TINY, **TINY_CONFIG[c["name"]])
        _dump(path, cfg)
    for w in spec["workloads"]:
        path = os.path.join(dest, "benchmark", "traffic", f"{w['traffic']}.json")
        with open(path) as fh:
            mix = json.load(fh)
        mix.update(TINY_SERVE if mix["kind"] == "serve" else TINY_TRAIN)
        _dump(path, mix)
        lim = os.path.join(dest, "benchmark", "limits", f"{w['name']}.json")
        with open(lim) as fh:
            _dump(lim, {k: TINY_LIMIT for k in json.load(fh)})
    _dump(os.path.join(dest, "BENCHMARK.json"), spec)
    return dest


def _dump(path, obj):
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(str(tmp_path))


def run_cpu(root: str, workload: str, seed: int = 5, seconds: float = 1.0):
    """Run a cell on the CPU from ``root``; returns (exit code, result)."""
    import contextlib
    import io

    from benchmark import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", "0"], root=root, device="cpu")
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


@pytest.fixture
def cuda_device():
    """Skip where there is no card (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
