"""The port's runner CLI on HJB, AllenCahn and SineNonlinear, in both
variants, at a tiny size on the CPU (d=3, 60 + 16 training points, 40 + 8
test points): the registries match the JAX runner's, the run writes the
JAX package's metrics.json keys with finite values, Sine tunes when
flagless and HJB and AllenCahn do not, AllenCahn records its MC oracle's
half-run disagreement, and no run reaches the fused posterior kernel's
launch counter (a CPU tensor takes the plain version).
"""

import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from scasml_gp_torch.gp import fused_posterior as fp  # noqa: E402
from scasml_gp_torch.harness import runner  # noqa: E402

torch.set_num_threads(2)

D = 3
EQUATIONS = ("HJB", "AllenCahn", "SineNonlinear")


def _leaves(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _leaves(v)
    else:
        yield obj


def test_registries_match_the_jax_runner():
    from scasml_gp_tpu.harness import runner as jrunner

    assert set(runner.GP_CLASSES) == set(jrunner.GP_CLASSES)
    for name, cls in jrunner.GP_CLASSES.items():
        assert runner.GP_CLASSES[name].__name__ == cls.__name__, name
    assert set(runner.EQUATIONS) == set(jrunner.EQUATIONS)


@pytest.mark.parametrize("variant", ["full_history", "quadrature"])
@pytest.mark.parametrize("equation", EQUATIONS)
def test_cli_runs_the_equation(tmp_path, capsys, equation, variant):
    fp.reset_launches()
    result = runner.main([
        "--equation", equation, "--dim", str(D), "--variant", variant,
        "--num-domain", "60", "--num-boundary", "16", "--test-domain", "40",
        "--test-boundary", "8", "--M", "3", "--device", "cpu", "--no-plots",
        "--save-path", str(tmp_path)])
    err = capsys.readouterr().err
    assert ("tuned GP config" in err) == (equation == "SineNonlinear")
    path = tmp_path / equation / f"{D}d" / variant / "SimpleUniform"
    with open(path / "metrics.json") as fh:
        m = json.load(fh)
    assert set(m["metrics"]) == {"GP", "MLP", "SCaSML"}
    t_tests = m.pop("t_tests")
    assert all(np.isfinite(v) for v in _leaves(m))
    for pair, t in t_tests.items():
        # scipy's paired t-test is NaN when the two error vectors are equal,
        # as they are when the guard abstains (SCaSML == GP)
        diff = m["diff_stats"][pair]
        same = diff["positive_count"] + diff["negative_count"] == 0
        assert all(np.isnan(v) if same else np.isfinite(v) for v in t.values()), pair
    assert m["valid_count"] == 48
    assert ("oracle_consistency" in m) == (equation == "AllenCahn")
    assert result["metrics"]["SCaSML"]["rel_L2"] < 0.5
    assert os.path.exists(path / "SimpleUniform.log")
    assert fp.launches == 0
