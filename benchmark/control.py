"""The control of the check: the plain reference put in the program's
place and computed one precision below the configuration's float32, that
is float32 with TF32 products, then judged by the cell's own numbers
against the float64 reference.  Its readings set the upper end of each
limit; the check is sound only if the control comes out not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

Needs the card (TF32 exists only there).  Prints one JSON line per seed
with each number beside the cell's limit.  The benchmark's runs never run
it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def tf32():
    """float32 matrix products in TF32 inside the block."""
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])


def readings(run, seed: int, device: str = "cuda", precision=tf32) -> dict:
    """The cell's numbers for the control at ``seed``: its trained state and
    its answers to as many of the mix's requests (or trains) as a run
    compares, against the float64 reference on the same inputs."""
    import numpy as np
    import torch

    from benchmark import compare, inputs, traffic
    from benchmark.reference import gp as rgp

    cfg, mix = run.config, run.traffic
    x_dom, x_bdy = inputs.collocation(cfg, seed, device)
    out = {}
    if mix["kind"] == "train":
        cands = traffic.train_candidates(mix, seed)
        picks = traffic.pick(len(cands), int(mix["check_trains"]), seed, "check")
        numbers = []
        for i in picks:
            ridge, gamma = cands[i]
            pb = compare.reference_problem(cfg, x_dom, x_bdy, ridge_scale=ridge,
                                           gamma_scale=gamma)
            ref = rgp.train(pb, int(cfg["gn_steps"]), compare.initial_point(x_dom))
            with precision():
                ctl = compare.reference_train(cfg, x_dom, x_bdy, torch.float32, ridge, gamma)
                u = rgp.posterior(ctl, ctl.x_dom).u.cpu().numpy()
            numbers.append(compare.train_numbers(pb, ref, u, ctl.sol.cpu().numpy()))
        return {"state_gap": max(n[0] for n in numbers),
                "loss_excess": max(n[1] for n in numbers)}
    ref = compare.reference_train(cfg, x_dom, x_bdy)
    with precision():
        ctl = compare.reference_train(cfg, x_dom, x_bdy, torch.float32)
        u = rgp.posterior(ctl, ctl.x_dom).u.cpu().numpy()
    out["train_gap"] = compare.gap(u, rgp.posterior(ref, ref.x_dom).u.cpu().numpy())
    reqs = traffic.Requests(mix, seed, int(cfg["dim"]), inputs.RADIUS, inputs.T0, inputs.T)
    # a run compares a seeded sample of its requests; here as many from the
    # cycle after the warm-up
    first = int(mix["warmup_requests"])
    picks = [first + i for i in traffic.pick(len(reqs.pool), int(mix["check_requests"]), seed,
                                             "check")]
    prog, want = [], []
    for i in picks:
        x = reqs.points(i)
        want.append(compare.reference_answer(cfg, ref, mix["endpoint"], x, cfg["buckets"]))
        with precision():
            prog.append(compare.reference_answer(cfg, ctl, mix["endpoint"], x, cfg["buckets"]))
    out[f"{mix['endpoint']}_gap"] = compare.gap(np.concatenate(prog), np.concatenate(want))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("the control needs a CUDA card", file=sys.stderr)
        return 2
    run = harness.Run(ROOT, args.workload, 0, 0.0, False, "cuda", 0.0)
    for seed in (int(s) for s in args.seeds.split(",")):
        vals = readings(run, seed)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": {
            k: {"value": v, "limit": run.limits[k]} for k, v in vals.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
