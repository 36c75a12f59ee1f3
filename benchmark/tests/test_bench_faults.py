"""A run whose timed path is broken underneath comes out not correct.

Each test runs a cell end to end on the CPU at the tests' size (the look
for a card skipped), with one of ``benchmark/faults.py``'s faults planted
in the port: a train whose steps leave its state unchanged; half of the
batch left out (a served chunk's answers for half its rows, the rest given
their mean; a train's PDE rows for half its interior points); one answer
altered where it is produced.  A sound run of the same cell comes out
correct."""

import json
import os

import pytest
import torch

from benchmark import faults
from conftest import ROOT, run_cpu

with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
    CELLS = [w["name"] for w in json.load(fh)["workloads"]]


def _serves(cell):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        traffic = {w["name"]: w["traffic"] for w in json.load(fh)["workloads"]}[cell]
    with open(os.path.join(ROOT, "benchmark", "traffic", f"{traffic}.json")) as fh:
        return json.load(fh)["kind"] == "serve"


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    rc, res = run_cpu(tiny_root, cell)
    assert rc == 0 and res["correct"], res["checks"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tiny_root, cell, fault):
    torch.manual_seed(0)
    with faults.planted(fault, _serves(cell)):
        rc, res = run_cpu(tiny_root, cell)
    assert rc == 0 and not res["correct"], res["checks"]
