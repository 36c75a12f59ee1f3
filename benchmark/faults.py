"""Faults planted in the program underneath a run, to show that the check
comes out not correct for each fault a cell can have.

- ``state_unchanged``: the Newton train takes no step, so the trained state
  is its initial point;
- ``half_batch``: half of the batch left out.  A served chunk's answers
  are computed for the first half of its real rows and the rest given their
  mean; a train keeps the PDE rows (F) of the first half of its interior
  points only, the other half's zero with their derivatives, shapes kept;
- ``answer_altered``: the first answer of a request, or of a train, moved
  by ``ALTERATION`` where it is produced.

(No cell spans chips, so there is no exchange to leave out.)  The tests
plant each at the tests' size on the CPU; on the card, at a cell's own
size:

    python3 benchmark/faults.py --workload <cell> --fault <fault> --seeds 1,2,3

runs the cell with the fault planted for ``--seconds`` a seed and prints
one JSON line a seed with each number beside its limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = ("state_unchanged", "half_batch", "answer_altered")
# about 0.4 of the answers' root mean square: a train's float32 answers at
# the widest kernels lie up to 0.05 of it from the float64 reference's
ALTERATION = 0.25


def _state_unchanged():
    from scasml_gp_torch.gp.solver import GP

    orig = GP._newton_body

    def no_steps(self, C, bdy_g, rhs, steps, *a, **k):
        return orig(self, C, bdy_g, rhs, 0, *a, **k)

    return [mock.patch.object(GP, "_newton_body", no_steps)]


def _half_served():
    from scasml_gp_torch.serve import SurrogateServer

    orig = SurrogateServer._run_bucketed

    def half(self, endpoint, fn, x, out_cols):
        def fn_half(chunk, real):
            y = fn(chunk, real).clone()
            keep = max(real // 2, 1)
            y[keep:] = y[:keep].mean(dim=0)
            return y
        return orig(self, endpoint, fn_half, x, out_cols)

    return [mock.patch.object(SurrogateServer, "_run_bucketed", half)]


def _half_interior():
    from scasml_gp_torch.gp.solver import GradDependentForm as Form

    def kept(z):
        m = z.new_ones(z.shape[-1:])
        m[(z.shape[-1] + 1) // 2:] = 0.0
        return m

    F, dF, d2F = Form.F, Form.dF, Form.d2F_contraction

    def F_half(self, z1, z3, z5, rhs):
        return F(self, z1, z3, z5, rhs) * kept(z1)

    def dF_half(self, z1, z3, z5):
        return tuple(d * kept(z1) for d in dF(self, z1, z3, z5))

    def d2F_half(self, w, z1, z3, z5):
        return {k: v * kept(z1) for k, v in d2F(self, w, z1, z3, z5).items()}

    return [mock.patch.object(Form, "F", F_half), mock.patch.object(Form, "dF", dF_half),
            mock.patch.object(Form, "d2F_contraction", d2F_half)]


def _answer_altered(serve: bool):
    if serve:
        from scasml_gp_torch.serve import SurrogateServer as owner

        name = "_run_bucketed"
    else:
        from scasml_gp_torch.gp.solver import GP as owner

        name = "GPsolver"
    orig = getattr(owner, name)

    def altered(self, *a, **k):
        out = orig(self, *a, **k)
        out = out.copy() if hasattr(out, "copy") else out.clone()
        out[0] += ALTERATION
        return out

    return [mock.patch.object(owner, name, altered)]


@contextlib.contextmanager
def planted(fault: str, serve: bool):
    """The program with ``fault`` planted, inside the block; ``serve`` says
    whether the cell serves requests or trains."""
    if fault == "state_unchanged":
        patches = _state_unchanged()
    elif fault == "half_batch":
        patches = _half_served() if serve else _half_interior()
    elif fault == "answer_altered":
        patches = _answer_altered(serve)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        yield


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Read a planted fault's numbers on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=FAULTS)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import time

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("the faults are read on a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(ROOT, args.workload, seed, args.seconds, False, "cuda",
                          time.perf_counter())
        with planted(args.fault, run.traffic["kind"] == "serve"):
            res = harness.execute(run)
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "correct": res["correct"], "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
