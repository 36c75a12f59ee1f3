"""Sharded end-to-end pipelines: GP training and the ScaSML solve over a mesh.

Port of ``scasml_gp_tpu/parallel/sharded.py``:

- GP training: the Gram's rows are split over the 'model' axis, each rank
  assembles its block and the ranks gather it; the factorization and the
  Newton steps run on every rank (gp/solver.py ``GP._train``).
- Picard rollout: the test batch is split over the 'data' axis; each rank
  rolls out its rows' whole sample tree and the ranks gather the outputs
  (picard/mlp.py ``sharded_rollout``).  The final u_hat splits the training
  rows over 'model' (gp/posterior.py ``shard_dom``).

The JAX package compiles the step into one program; here it runs eagerly,
one process per rank, each issuing the same collectives in the same order.

``dryrun_multichip(n)`` runs one sharded train and solve step in n gloo CPU
processes, at the sizes of the JAX package's ``__graft_entry__``
``dryrun_multichip``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Callable, Optional

import torch

from scasml_gp_torch.gp.posterior import posterior_eval
from scasml_gp_torch.gp.state import GPState
from scasml_gp_torch.picard.core import build_full_history_uz, build_quadrature_uz
from scasml_gp_torch.picard.mlp import sharded_rollout


def make_sharded_train_and_solve(eq, gp, scasml, mesh, n: int = 2, M: int = 3,
                                 rho: Optional[int] = None,
                                 gn_steps: int = 8) -> Callable:
    """``step(x_dom, x_bdy, x_test, gen) -> u`` over the mesh: trains the GP
    (the Gram's rows over 'model'), assembles a GPState, runs the
    GP-calibrated Picard rollout on the 'data'-split test batch, and returns
    u_hat + u_breve, the whole ScaSML prediction (batch, 1), on every rank.
    ``gen`` is a torch.Generator seeded the same on every rank.  The
    rollout's own posterior calls split the training rows over the GP's
    mesh, as the JAX package's take ``GP._dom_sharding``."""
    model_spec = scasml._model()
    if rho is not None:
        from scasml_gp_torch.picard.schedule import approx_parameters

        uz_fn = build_quadrature_uz(model_spec, n, rho, approx_parameters(rho, eq.T))
    else:
        uz_fn = build_full_history_uz(model_spec, n, M)
    cfg = gp.config
    shard_dom = mesh if mesh.model > 1 else None

    def step(x_dom, x_bdy, x_test, gen):
        bdy_g = eq.g(x_bdy)[:, 0].to(torch.float32)
        rhs = gp.form.rhs_f(x_dom).to(torch.float32)
        gamma = torch.tensor(gp.gamma, dtype=torch.float32, device=x_dom.device)
        out = gp._train(x_dom, x_bdy, bdy_g, rhs, gamma, gp.nugget, gn_steps,
                        cfg.damping, cfg.grad_tol, mesh=mesh)
        state = GPState(x_dom=x_dom, x_bdy=x_bdy, right_vector=out.right_vector,
                        sol=out.sol, gamma=gamma, loss_history=out.loss_history)
        uz = sharded_rollout(uz_fn, x_test, gen, state, mesh)
        od = gp.precision.gram_dtype
        u_hat = posterior_eval(
            x_test, x_dom, x_bdy, state.right_vector, gamma, eq.dim,
            operand_dtype=od, shard_dom=shard_dom,
            fused=(state.fused_inputs(od, shard_dom)
                   if x_test.is_cuda or shard_dom is not None else None),
        ).u[:, None]
        return u_hat + uz[:, :1]

    return step


def make_sharded_picard_solve(uz_fn: Callable, mesh) -> Callable:
    """A built Picard rollout ``uz_fn(x_t, gen, params)`` with its batch
    split over the mesh's 'data' axis: each rank rolls out its rows with the
    whole batch's draws, and the ranks gather the outputs."""

    def solve(x_t, gen, params):
        return sharded_rollout(uz_fn, x_t, gen, params, mesh)

    return solve


DRYRUN_D = 8
DRYRUN_TIMEOUT_S = 240


def _dryrun_step(n_devices: int) -> torch.Tensor:
    """One rank's sharded train and solve step, at the JAX dryrun's sizes."""
    import scasml_gp_torch as port
    from scasml_gp_torch.parallel.mesh import make_mesh

    model_axis = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(data=n_devices // model_axis, model=model_axis)
    n_dom, n_bdy, batch = 4 * n_devices, 8, 4 * n_devices
    eq = port.GradDependentNonlinear(n_input=DRYRUN_D + 1)
    # the GP carries the mesh, so the rollout's own posterior calls split
    # the training rows over 'model' too
    gp = port.GPGradDependentNonlinear(eq, port.GPConfig(gn_steps=2), device="cpu",
                                       mesh=mesh)
    scasml = port.ScaSMLFullHistory(eq, gp)
    x_dom, x_bdy = eq.generate_data(n_dom, n_bdy, torch.Generator().manual_seed(0),
                                    device="cpu")
    x_test = eq.geometry().sample_domain(torch.Generator().manual_seed(1), batch,
                                         device="cpu")
    step = make_sharded_train_and_solve(eq, gp, scasml, mesh, n=2, M=2, gn_steps=2)
    out = step(x_dom, x_bdy, x_test, torch.Generator().manual_seed(2))
    if out.shape != (batch, 1):
        raise RuntimeError(f"sharded step output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("non-finite output from the sharded step")
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_gloo_world(child: str, n: int, timeout: float, args: tuple = ()) -> list:
    """Run ``child(rank, n, port, *args)`` (``child`` the dotted path of a
    function, ``args`` literals) in n fresh CPU processes, which join one
    gloo world through ``port``; returns each rank's (returncode, output).
    A rank that outlives ``timeout`` seconds is killed."""
    port = _free_port()
    module, fn = child.rsplit(".", 1)
    tail = "".join(f", {a!r}" for a in args)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"from {module} import {fn}; {fn}({rank}, {n}, {port}{tail})"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=root)
        for rank in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def dryrun_multichip(n_devices: int) -> None:
    """Run one sharded train and solve step on an n_devices mesh of gloo CPU
    processes (data x model, model = 2 when n is even): GP training with the
    Gram's rows over 'model', the ScaSML rollout with the batch over 'data'.
    Raises unless every process finishes with the same finite output."""
    runs = run_gloo_world("scasml_gp_torch.parallel.sharded._dryrun_child", n_devices,
                          DRYRUN_TIMEOUT_S)
    sums = set()
    for rank, (rc, out) in enumerate(runs):
        if rc != 0 or f"OK rank={rank}" not in out:
            raise RuntimeError(f"dryrun_multichip: rank {rank} failed:\n{out}")
        sums.add(out.split("sum=")[1].split()[0])
    if len(sums) != 1:
        raise RuntimeError(f"dryrun_multichip: the ranks' outputs differ: {sums}")


def _dryrun_child(rank: int, n_devices: int, port: int) -> None:
    from scasml_gp_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", n_devices, rank, backend="gloo")
    try:
        out = _dryrun_step(n_devices)
        print(f"OK rank={rank} sum={float(out.double().sum()):.9e}", flush=True)
    finally:
        torch.distributed.destroy_process_group()
