"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Everything that belongs to one cell is found by name from
``BENCHMARK.json``:

- ``benchmark/configs/<config>.json``: the configuration (the ``file`` of
  its ``configs`` entry);
- ``benchmark/traffic/<traffic>.json``: the mix, read by ``traffic.py``;
  its ``kind`` names the module ``benchmark/kinds/<kind>.py`` that sets
  the cell up, drives its window and checks it;
- ``benchmark/metrics/<metric>.py``: one reader per metric, end to end or
  per layer, ``read(run) -> float or None``.  A quantity split by the
  end-to-end metric it moves (``device_idle.serve``, ``device_idle.train``)
  is read by the file of its stem (``device_idle.py``) where it has none of
  its own;
- ``benchmark/limits/<cell>.json``: the limit of each number that decides
  ``correct``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

from benchmark import trace

# the modules whose presence in the process spoils a run of the port
FORBIDDEN = ("jax", "jaxlib", "flax", "scasml_gp_tpu")


class Run:
    """What one run knows: its cell, its inputs, what the window logged and,
    in a traced run, the trace."""

    def __init__(self, root: str, workload: str, seed: int, seconds: float,
                 trace: bool, device: str, t_start: float):
        self.root, self.workload, self.seed = root, workload, int(seed)
        self.seconds, self.trace, self.device = float(seconds), bool(trace), device
        self.t_start = t_start
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.spec = json.load(fh)
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        cfg_entry = {c["name"]: c for c in self.spec["configs"]}[self.cell["config"]]
        self.config = _load_json(root, cfg_entry["file"])
        self.traffic = _load_json(root, f"benchmark/traffic/{self.cell['traffic']}.json")
        self.limits = _load_json(root, f"benchmark/limits/{workload}.json")
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.log: List[dict] = []        # one entry per request or train
        self.checks: List[tuple] = []    # (name, value, limit)
        self.tracer: Optional[trace.Tracer] = None
        self.tr: Optional[dict] = None   # the reduced trace, in a traced run
        self.peak_bytes = 0

    def metric_names(self, group: str) -> List[str]:
        """The cell's metrics of ``group`` ('end_to_end' or 'per_layer')."""
        return [m["name"] for m in self.spec[group]
                if "workloads" not in m or self.workload in m["workloads"]]


def _load_json(root: str, rel: str) -> dict:
    with open(os.path.join(root, rel)) as fh:
        return json.load(fh)


def load_module(root: str, rel: str, name: str):
    """The Python file ``rel`` under ``root`` as a module named ``name``
    (metric names hold dots, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(root, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: str, name: str):
    """The reader module of the metric ``name``: ``metrics/<name>.py``, else
    that of its stem, the name up to its last dot."""
    rel = f"benchmark/metrics/{name}.py"
    if not os.path.exists(os.path.join(root, rel)) and "." in name:
        rel = f"benchmark/metrics/{name.rsplit('.', 1)[0]}.py"
    return load_module(root, rel, f"_metric_{name}")


def read_metrics(run: Run, names: List[str]) -> Dict[str, dict]:
    """{name: {value, unit}} of each metric whose reader finds a value."""
    units = {m["name"]: m["unit"] for g in ("end_to_end", "per_layer") for m in run.spec[g]}
    out = {}
    for name in names:
        value = reader(run.root, name).read(run)
        if value is not None:
            out[name] = {"value": float(value), "unit": units[name]}
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def execute(run: Run) -> dict:
    """Set up, measure, check; returns the result object (without
    printing)."""
    import torch

    kind = load_module(run.root, f"benchmark/kinds/{run.traffic['kind']}.py",
                       f"_kind_{run.traffic['kind']}")
    cuda = run.device.startswith("cuda")
    state = kind.setup(run)
    if cuda:
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - run.t_start
    run.tracer = trace.Tracer(run.trace, run.traffic["trace_seconds"])
    kind.window(run, state)
    run.tracer.stop()
    if cuda:
        torch.cuda.synchronize()
        run.peak_bytes = int(torch.cuda.max_memory_allocated())
    if run.trace:
        run.tr = trace.reduce(run.tracer.raw, run.tracer.items)
    kind.free(state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    group = "per_layer" if run.trace else "end_to_end"
    metrics = read_metrics(run, run.metric_names(group))
    run.checks = kind.check(run, state)
    correct = all(v <= lim for _, v, lim in run.checks)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": int(run.cell.get("chips", 1)),
              "memory_peak_bytes": run.peak_bytes,
              "power": power_limit() if cuda else None}
    # a request or train that raises ends the run: none fails and is counted
    result = {"correct": correct, "attempted": len(run.log), "failed": 0,
              "metrics": metrics, "device": device}
    if run.trace:
        device["busy_s"] = run.tr["busy_s"]
        device["window_s"] = run.tr["window_s"]
        result["breakdown"] = run.tr["breakdown"]
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in run.checks}
    return result
