"""The port's device mesh (scasml_gp_torch.parallel) on torch.distributed:
gloo worlds of 2 and 4 CPU processes (tests/_torch_mesh_child.py), each
check holding a sharded run against the same run without a mesh, and the
sharded train-and-solve step against the JAX package's
(tests/test_sharding.py).

Tolerances (the JAX package's): the 'data' axis at rtol 1e-4, atol 1e-5
(tests/test_sharding.py: the ranks roll out the same numbers and gather
them), the 'model' axis at rtol 2e-3, atol 2e-4 (tests/test_precision.py:
partial sums over the training rows added in another order).  The children
run each world's checks in one spawn: each pays ~5 s of torch import.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from scasml_gp_torch.parallel import dryrun_multichip, make_mesh  # noqa: E402
from scasml_gp_torch.parallel import mesh as pm  # noqa: E402

torch.set_num_threads(2)

CHILD = os.path.join(os.path.dirname(__file__), "_torch_mesh_child.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(world: int, outdir) -> list:
    """Each rank's output; a rank that fails or hangs fails the test."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, CHILD, str(r), str(world), str(port),
                               str(outdir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    runs = {}
    for world in (2, 4):
        out = tmp_path_factory.mktemp(f"world{world}")
        runs[world] = (_run_world(world, out), out)
    return runs


def _passed(worlds, world, check):
    runs, _ = worlds[world]
    for rank, (rc, out) in enumerate(runs):
        assert f"CHECK {check} OK" in out, f"rank {rank} of {world} (rc {rc}):\n{out}"


def test_mesh_shapes_and_errors(worlds):
    """make_mesh over one process, and in worlds of 2 and 4: shapes, the
    ranks' coordinates, the JAX package's errors, the row ranges."""
    mesh = make_mesh(1, 1)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.data_group is None
    assert make_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match=r"mesh 2x1 needs 2 > 1 devices"):
        make_mesh(2, 1)
    with pytest.raises(ValueError, match="1 devices not divisible by model=2"):
        make_mesh(-1, 2)
    assert pm.split_range(10, 3, 2) == (6, 10) and pm.replicated(mesh, 7) == (0, 7)
    x = torch.arange(6.0)
    assert pm.all_reduce_sum(x, None) is x
    with pytest.raises(TypeError, match="Mesh"):
        pm.check_mesh("data")
    _passed(worlds, 2, "mesh_shapes")
    _passed(worlds, 4, "mesh_shapes")


def test_data_sharded_solve_matches_world_one(worlds):
    _passed(worlds, 2, "data_solve")
    _passed(worlds, 4, "data_solve")


def test_model_sharded_posterior_matches_world_one(worlds):
    _passed(worlds, 2, "model_posterior")
    _passed(worlds, 4, "model_posterior")


def test_model_sharded_dense_train_matches_world_one(worlds):
    _passed(worlds, 2, "model_dense_train")


def test_row_sharded_dual_cg_matches_world_one(worlds):
    _passed(worlds, 2, "model_dual_cg")


def test_runner_with_a_mesh(worlds):
    _passed(worlds, 2, "runner")


def test_load_surrogate_on_a_mesh(worlds):
    _passed(worlds, 2, "serve")


def test_sharded_train_and_solve_matches_jax(worlds):
    """make_sharded_train_and_solve on a 2 x 2 mesh of 4 processes: rel-L2
    below 0.5 end to end (the JAX test's bar), and its GP part (n = 0) within
    2e-3 of the JAX package's make_sharded_train_and_solve on the same
    points (their Newton trains start from different draws of one law)."""
    from scasml_gp_tpu.config import GPConfig as JaxGPConfig
    from scasml_gp_tpu.equations import GradDependentNonlinear as JaxEq
    from scasml_gp_tpu.gp import GPGradDependentNonlinear as JaxGP
    from scasml_gp_tpu.parallel import make_mesh as jax_make_mesh
    from scasml_gp_tpu.parallel import make_sharded_train_and_solve as jax_step
    from scasml_gp_tpu.picard.scasml import ScaSMLFullHistory as JaxScaSML

    _passed(worlds, 4, "sharded_step")
    with np.load(os.path.join(worlds[4][1], "sharded_step.npz")) as f:
        data = dict(f)
    eq = JaxEq(n_input=data["x_dom"].shape[1])
    gp = JaxGP(eq, JaxGPConfig(gn_steps=8))
    step = jax_step(eq, gp, JaxScaSML(eq, gp),
                    jax_make_mesh(data=1, model=1, devices=jax.devices()[:1]),
                    n=0, M=3, gn_steps=8)
    want = np.asarray(step(jnp.asarray(data["x_dom"]), jnp.asarray(data["x_bdy"]),
                           jnp.asarray(data["x_test"]), jax.random.PRNGKey(2)))
    np.testing.assert_allclose(data["u_hat"], want, rtol=2e-3, atol=2e-4)


def test_dryrun_multichip():
    """The port's dryrun_multichip(4): one sharded train and solve step on a
    2 x 2 mesh of 4 gloo processes, the same finite output on every rank."""
    dryrun_multichip(4)
