"""The port imports neither JAX nor the JAX package: the GPU host has no JAX,
so one stray import would break the port there.  Checked in a fresh
interpreter, since this test process has JAX loaded already; nor does it
import the JAX package's drivers under scripts/.  "*" imports
every module of the package, found by walking it, and chip_smoke.py;
"mesh child" imports tests/_torch_mesh_child.py, which the gloo worlds of
tests/test_torch_mesh.py run."""

import os
import subprocess
import sys

import pytest

MODULES = ("scasml_gp_torch", "scasml_gp_torch.harness.runner",
           "scasml_gp_torch.gp.tuning", "scasml_gp_torch.gp.marginal",
           "scasml_gp_torch.gp.distributed", "scasml_gp_torch.serve",
           "scasml_gp_torch.utils.debug", "scasml_gp_torch.parallel.mesh",
           "scasml_gp_torch.parallel.sharded", "scasml_gp_torch.gp.parity",
           "scasml_gp_torch.scripts.run_all", "scasml_gp_torch.scripts.summarize_campaign",
           "scasml_gp_torch.scripts.throughput", "scasml_gp_torch.scripts.high_dim",
           "scasml_gp_torch.scripts.stretch_d250", "scasml_gp_torch.picard.graphs",
           "*", "mesh child")


@pytest.mark.parametrize("module", MODULES)
def test_port_imports_no_jax(module):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if module == "*":
        load = (
            "import pkgutil, scasml_gp_torch, chip_smoke\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    scasml_gp_torch.__path__, 'scasml_gp_torch.')]\n"
            "assert 'scasml_gp_torch.harness.computing_budget' in names, names\n"
            "assert 'scasml_gp_torch.scripts.stretch_d250' in names, names\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
        )
    elif module == "mesh child":
        load = ("sys.path.insert(0, 'tests')\n"
                "importlib.import_module('_torch_mesh_child')\n")
    else:
        load = f"importlib.import_module({module!r})\n"
    code = (
        "import importlib, sys\n"
        + load
        + "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'scasml_gp_tpu')\n"
        "             or m == 'scripts' or m.startswith('scripts.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
