"""On the card: the control (the reference in float32 with TF32 products in
the program's place) comes out not correct in every cell, at the cell's
own size.  Run there with

    python -m pytest benchmark/tests/test_bench_control.py -m cuda
"""

import json
import os

import pytest

from conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
    CELLS = [w["name"] for w in json.load(fh)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cuda_device, cell):
    from benchmark import control, harness

    run = harness.Run(ROOT, cell, 0, 0.0, False, cuda_device, 0.0)
    vals = control.readings(run, 20260101)
    assert any(v > run.limits[k] for k, v in vals.items()), vals
