"""The port imports neither JAX nor the JAX package: the GPU host has no JAX,
so one stray import would break the port there.  Checked in a fresh
interpreter, since this test process has JAX loaded already."""

import os
import subprocess
import sys

import pytest

MODULES = ("scasml_gp_torch", "scasml_gp_torch.harness.runner",
           "scasml_gp_torch.gp.tuning")


@pytest.mark.parametrize("module", MODULES)
def test_port_imports_no_jax(module):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'scasml_gp_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
