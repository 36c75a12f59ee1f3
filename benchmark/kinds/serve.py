"""A serve cell: one client calls ``SurrogateServer`` in a closed loop.

Set-up builds the kernel library, makes the collocation points from the
seed, trains the GP with ``GP.GPsolver`` at the configuration's Newton
steps and nugget, builds the server over it (the configuration's ScaSML
solver behind /solve, its buckets, deterministic solves) and warms the
mix's endpoint up, which captures every bucket's CUDA graphs, then sends
the stream's first ``warmup_requests`` requests untimed: a window's first
seconds ran slower without them.  The window sends the next requests one
after another, each timed from the call to the returned numpy array.

The check compares, with the plain reference in float64 (``reference/``,
trained again from the same points):

- ``train_gap``: the trained GP's posterior mean at its interior points, as
  ``GPsolver`` returned it at set-up;
- ``solve_gap`` or ``predict_gap``: every row of ``check_requests`` of the
  window's requests, a uniform sample drawn from the seed as the window
  runs (``traffic.Reservoir``: the window keeps no other answer).  A /solve
  answer is reproduced as the server defines it: the chunk padded to its
  bucket by repeating its last row, the solver's generator reseeded with
  ``solve_seed``, the recursion over the bucket's rows drawing the same
  random numbers.

Each number is the widest gap, as a share of the reference's root mean
square over the rows compared.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import inputs, traffic
from benchmark.compare import SOLVE_SEED, gap, port_gp, reference_answer, reference_train
from benchmark.reference import gp as rgp


class State:
    pass


def setup(run):
    from scasml_gp_torch import ScaSML, ScaSMLFullHistory
    from scasml_gp_torch.serve import SurrogateServer
    from scasml_gp_torch.utils import build

    cfg, dev = run.config, run.device
    if dev.startswith("cuda"):
        build.load_library()
    st = State()
    st.x_dom, st.x_bdy = inputs.collocation(cfg, run.seed, dev)
    eq, gp = port_gp(cfg, dev)
    st.u_dom = gp.GPsolver(st.x_dom, st.x_bdy).detach().cpu().numpy()[:, 0]
    solver = None
    rho = None
    if run.traffic["endpoint"] == "solve":
        if cfg["solver"] == "quadrature":
            solver, rho = ScaSML(eq, gp), int(cfg["rho"])
        else:
            solver = ScaSMLFullHistory(eq, gp)
    st.server = SurrogateServer(gp, solver, buckets=cfg["buckets"], n=int(cfg["n"]),
                                rho=rho, M=int(cfg.get("M") or 3), deterministic=True,
                                solve_seed=SOLVE_SEED)
    st.server.warmup(endpoints=(run.traffic["endpoint"],))
    st.requests = traffic.Requests(run.traffic, run.seed, int(cfg["dim"]), inputs.RADIUS,
                                   inputs.T0, inputs.T)
    call = getattr(st.server, run.traffic["endpoint"])
    st.first = int(run.traffic["warmup_requests"])
    for i in range(st.first):
        call(st.requests.points(i))
    return st


def window(run, st) -> None:
    call = getattr(st.server, run.traffic["endpoint"])
    span = f"server.{run.traffic['endpoint']}"
    tracer = run.tracer
    st.kept = traffic.Reservoir(int(run.traffic["check_requests"]), run.seed, "check")
    if run.device.startswith("cuda"):
        torch.cuda.synchronize()
    tracer.start()
    t0 = time.perf_counter()
    i, now = st.first, t0
    while now - t0 < run.seconds:
        traced = tracer.active
        with tracer.span("request"):
            x = st.requests.points(i)
            a = time.perf_counter()
            with tracer.span(span):
                y = call(x)
            now = time.perf_counter()
        run.log.append({"rows": x.shape[0], "latency_s": now - a, "traced": traced})
        st.kept.offer((i, y))
        if tracer.after_item(now):
            now = time.perf_counter()   # the profiler's stop is not work
        i += 1
    run.window_s = now - t0


def free(st) -> None:
    """Drop the program's objects; the inputs and the kept answers stay."""
    st.server = None


def check(run, st) -> list:
    cfg = run.config
    trained = reference_train(cfg, st.x_dom, st.x_bdy)
    u_ref = rgp.posterior(trained, trained.x_dom).u.cpu().numpy()
    checks = [("train_gap", gap(st.u_dom, u_ref), run.limits["train_gap"])]
    prog, ref = [], []
    for i, y in sorted(st.kept.items, key=lambda item: item[0]):
        ref.append(reference_answer(cfg, trained, run.traffic["endpoint"],
                                    st.requests.points(i), cfg["buckets"]))
        prog.append(y[:, 0])
    name = f"{run.traffic['endpoint']}_gap"
    checks.append((name, gap(np.concatenate(prog), np.concatenate(ref)), run.limits[name]))
    return checks
