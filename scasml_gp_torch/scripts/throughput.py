"""Sampling throughput of the Picard rollout, per device and sharded.

Port of ``scripts/throughput.py``: the full-history MLP rollout's
generator-evaluation throughput (the "samples/sec/chip" metric), at
GradDependentNonlinear d=100, batch 1200, (n, M) = (3, 4) by default:

    python -m scasml_gp_torch.scripts.throughput [--d 100] [--device cuda]

Two warm-up calls (on the card the first runs eagerly and the second
captures the rollout as a CUDA graph, which the timed calls replay:
picard/graphs.py), then ``--reps`` calls timed on the host clock with one
``torch.cuda.synchronize()`` after the last.  ``evals_per_call`` is
``count_evaluations_full_history(n, M)`` per batch row.  Under ``torchrun``
with more than one rank, each rank measures its own device and then the
rollout with the batch split over a ('data' = world) mesh
(``parallel.make_sharded_picard_solve``, eager: its gather is a collective);
rank 0 prints the JSON.  With one
process the sharded leg is left out, as the JAX script leaves it out on one
device.

    torchrun --nproc-per-node 4 -m scasml_gp_torch.scripts.throughput
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from scasml_gp_torch.equations import GradDependentNonlinear
from scasml_gp_torch.parallel import initialize_distributed, make_mesh, make_sharded_picard_solve
from scasml_gp_torch.parallel.mesh import rank_device, world
from scasml_gp_torch.picard import MLPFullHistory
from scasml_gp_torch.picard.schedule import count_evaluations_full_history
from scasml_gp_torch.utils.device import resolve_device


def _timed_calls(call, reps: int) -> float:
    """Seconds per call of ``call()`` over ``reps`` calls after two warm-up
    calls, the device drained before the clock stops."""
    for _ in range(2):
        out = call()
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = call()
    _sync(out)
    return (time.perf_counter() - t0) / reps


def _sync(out: torch.Tensor) -> None:
    if out.is_cuda:
        torch.cuda.synchronize(out.device)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--d", type=int, default=100)
    parser.add_argument("--batch", type=int, default=1200)
    parser.add_argument("--n", type=int, default=3)
    parser.add_argument("--M", type=int, default=4)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; a missing "
                             "CUDA device is an error)")
    args = parser.parse_args(argv)

    initialize_distributed()  # a torchrun launch; a no-op for one process
    rank, n_ranks = world()
    dev = resolve_device(rank_device(args.device) if n_ranks > 1 else args.device)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}"
          f" (rank {rank} of {n_ranks})", file=sys.stderr)

    eq = GradDependentNonlinear(n_input=args.d + 1)
    solver = MLPFullHistory(eq, device=dev, seed=1)
    x_t = eq.geometry().sample_domain(torch.Generator(device=dev).manual_seed(0),
                                      args.batch, device=dev)
    nevals = count_evaluations_full_history(args.n, args.M)

    # one device, steady state: the solver's entry point
    t_single = _timed_calls(lambda: solver.uz_solve(args.n, None, x_t, M=args.M),
                            args.reps)
    result = {
        "d": args.d, "batch": args.batch, "n": args.n, "M": args.M,
        "evals_per_call": int(nevals),
        "single_device_s": t_single,
        "gsamples_per_sec_per_device": nevals * args.batch / t_single / 1e9,
    }

    # the batch over every rank ('data' axis)
    if n_ranks > 1:
        mesh = make_mesh(data=n_ranks, model=1)
        sharded = make_sharded_picard_solve(solver._build((args.n, args.M)), mesh)
        gen = torch.Generator(device=dev).manual_seed(1)
        t_multi = _timed_calls(lambda: sharded(x_t, gen, None), args.reps)
        result["n_devices"] = n_ranks
        result["sharded_s"] = t_multi
        result["scaling_efficiency"] = t_single / (t_multi * n_ranks)

    if rank == 0:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
