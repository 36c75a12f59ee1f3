"""The port's debug NaN checks (``debug_checks=True``, ``--debug-checks``;
scasml_gp_torch.utils.debug) against the JAX package's checkify float
checks, the cases of tests/test_picard.py's debug section: a checked run
equals the unchecked one, and a NaN in the input raises naming an op where
the unchecked solver lets it through.  Then the runner's once-unported
flags, ``--debug-checks`` and ``--train-backend distributed``, through
``runner.main`` at the tiny size."""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import scasml_gp_torch as port  # noqa: E402
from scasml_gp_torch.harness import runner  # noqa: E402
from scasml_gp_torch.picard import mlp as port_mlp  # noqa: E402
from scasml_gp_torch.utils.debug import FloatCheckError, FloatChecks, active  # noqa: E402

torch.set_num_threads(2)

D = 4


def _points(n, nan=False):
    eq = port.GradDependentNonlinear(n_input=D + 1)
    x = eq.geometry().sample_domain(torch.Generator().manual_seed(0), n)
    if nan:
        x[0, 0] = float("nan")
    return eq, x


@pytest.fixture(scope="module")
def trained_gp():
    eq = port.GradDependentNonlinear(n_input=D + 1)
    gp = port.GPGradDependentNonlinear(eq, port.GPConfig(gn_steps=4), device="cpu")
    gp.GPsolver(*eq.generate_data(60, 16, torch.Generator().manual_seed(1)))
    return gp


def _solvers(kind, gp, **kw):
    eq = gp.equation
    if kind == "mlp":
        return port.MLPFullHistory(eq, device="cpu", seed=7, **kw)
    return port.ScaSMLFullHistory(eq, gp, seed=7, **kw)


@pytest.mark.parametrize("kind", ["mlp", "scasml"])
def test_debug_checks_clean_run_matches_unchecked(trained_gp, kind):
    """debug_checks=True changes nothing on finite inputs: the same bits."""
    _, x = _points(32)
    u_ref = _solvers(kind, trained_gp).u_solve(2, 2, x, M=2)
    u_dbg = _solvers(kind, trained_gp, debug_checks=True).u_solve(2, 2, x, M=2)
    assert torch.equal(u_dbg, u_ref)


@pytest.mark.parametrize("kind", ["mlp", "scasml"])
def test_debug_checks_localizes_nan(trained_gp, kind):
    """A NaN in the input raises the port's error naming the aten op that
    made the first NaN, as checkify does in the JAX package; the unchecked
    solver returns the NaN."""
    _, x = _points(8, nan=True)
    with pytest.raises(FloatCheckError, match=r"nan generated by aten op aten\.\w+"):
        _solvers(kind, trained_gp, debug_checks=True).u_solve(2, 2, x, M=2)
    out = _solvers(kind, trained_gp).u_solve(2, 2, x, M=2)
    assert torch.isnan(out[0]).any() and torch.isfinite(out[1:]).all()


def test_jax_debug_checks_raise_on_the_same_input():
    """The reference behaviour the port's error stands for."""
    from jax.experimental import checkify

    from scasml_gp_tpu.equations import GradDependentNonlinear as JaxEq
    from scasml_gp_tpu.picard import MLPFullHistory as JaxMLP

    _, x = _points(8, nan=True)
    dbg = JaxMLP(JaxEq(n_input=D + 1), debug_checks=True)
    with pytest.raises(checkify.JaxRuntimeError, match="nan"):
        dbg.u_solve(2, None, jnp.asarray(x.numpy()), M=2)


def test_float_checks_raise_on_nan_only():
    """NaN raises; inf does not (checkify's nan check); uninitialised
    allocations are not read; the mode is visible to code that launches
    work it cannot see.  The error is a RuntimeError."""
    assert issubclass(FloatCheckError, RuntimeError)
    assert not active()
    with FloatChecks():
        assert active()
        big = torch.tensor([1.0]) / 0.0  # inf
        assert torch.isinf(big).all()
        torch.empty(1000)
        with pytest.raises(FloatCheckError, match="aten.sub"):
            big - big
    assert not active()


def _small_argv(tmp_path, *extra):
    return ["--dim", "3", "--num-domain", "60", "--num-boundary", "16",
            "--test-domain", "40", "--test-boundary", "8", "--device", "cpu",
            "--save-path", str(tmp_path), "--variant", "full_history", "--M", "2",
            "--no-plots", "--no-tune", *extra]


# Once in tests/test_torch_harness.py::test_unported_flags_raise (ids
# extra6 and extra7), when both flags raised NotImplementedError.
@pytest.mark.parametrize("extra,checked", [
    pytest.param(["--debug-checks"], True, id="extra6"),
    pytest.param(["--train-backend", "distributed"], False, id="extra7"),
])
def test_once_unported_flags_run_through_main(tmp_path, monkeypatch, extra, checked):
    wrapped = []
    orig = port_mlp.float_checked
    monkeypatch.setattr(port_mlp, "float_checked",
                        lambda fn: wrapped.append(fn) or orig(fn))
    trained = []
    orig_dist = port.GP._gpsolver_distributed
    monkeypatch.setattr(port.GP, "_gpsolver_distributed",
                        lambda self, *a: trained.append(self) or orig_dist(self, *a))
    runner.main(_small_argv(tmp_path, *extra))
    path = tmp_path / "GradDependentNonlinear" / "3d" / "full_history" / "SimpleUniform"
    with open(path / "metrics.json") as fh:
        m = json.load(fh)
    rel = {k: v["rel_L2"] for k, v in m["metrics"].items()}
    assert all(np.isfinite(v) for v in rel.values())
    assert rel["GP"] < 0.5 and rel["SCaSML"] < 0.5
    assert bool(wrapped) == checked
    assert bool(trained) == (not checked)
