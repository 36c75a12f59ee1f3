"""A train cell: ``GP.GPsolver`` trains back to back on one seeded
collocation set, cycling the mix's kernel candidates, as a flagless tune
does.

Set-up builds the kernel library, makes the points from the seed, makes one
GP per candidate and trains the first candidate once (the warm-up).  The
window runs whole trains, each ended by copying the trained posterior mean
at the interior points to the host (what ``GPsolver`` returns).

The check takes a sample of the window's trains, drawn from the seed as the
window runs (``traffic.Reservoir``), and for each trains the candidate again
with the plain reference in float64 (its Gram, C = (K + nugget I)^{-1}, the
Newton steps from the same initial point):

- ``state_gap``: the train's answer, its posterior mean at the interior
  points, against the reference's posterior from the train's own final
  unknowns (weights C b(sol)): the widest gap over the sample, as a share of
  the reference's root mean square;
- ``loss_excess``: the objective b^T C b at the train's final unknowns, in
  float64, over the reference train's, less 1: the most over the sample.

The answer is not held to the reference's own train: over 20 steps of this
non-convex Newton, float32 and float64 trains of one candidate part ways on
some seeds, to other minima of the objective (PERF.md).
"""

from __future__ import annotations

import time

import torch

from benchmark import inputs, traffic
from benchmark.compare import initial_point, port_gp, reference_problem, train_numbers
from benchmark.reference import gp as rgp


class State:
    pass


def setup(run):
    from scasml_gp_torch.utils import build

    cfg, dev = run.config, run.device
    if dev.startswith("cuda"):
        build.load_library()
    st = State()
    st.x_dom, st.x_bdy = inputs.collocation(cfg, run.seed, dev)
    st.candidates = traffic.train_candidates(run.traffic, run.seed)
    st.gps = [port_gp(cfg, dev, r, g)[1] for r, g in st.candidates]
    st.gps[0].GPsolver(st.x_dom, st.x_bdy).detach().cpu()
    return st


def window(run, st) -> None:
    tracer = run.tracer
    # (candidate index, u at the interior points, state) of a sample of the
    # trains, drawn from the seed as the window runs
    st.kept = traffic.Reservoir(int(run.traffic["check_trains"]), run.seed, "check")
    if run.device.startswith("cuda"):
        torch.cuda.synchronize()
    tracer.start()
    t0 = time.perf_counter()
    i, now = 0, t0
    while now - t0 < run.seconds:
        traced = tracer.active
        c = i % len(st.gps)
        gp = st.gps[c]
        with tracer.span("train"):
            u = gp.GPsolver(st.x_dom, st.x_bdy).detach().cpu().numpy()[:, 0]
        now = time.perf_counter()
        run.log.append({"traced": traced})
        st.kept.offer((c, u, gp.state))
        if tracer.after_item(now):
            now = time.perf_counter()   # the profiler's stop is not work
        i += 1
    run.window_s = now - t0


def free(st) -> None:
    """Drop the program's GPs; the kept trains' answers and final unknowns
    stay, on the host."""
    st.kept.items = [(c, u, s.sol.cpu().numpy()) for c, u, s in st.kept.items]
    st.gps = None


def check(run, st) -> list:
    cfg = run.config
    numbers = []
    for c, u, sol in st.kept.items:
        ridge, gamma = st.candidates[c]
        pb = reference_problem(cfg, st.x_dom, st.x_bdy, ridge_scale=ridge, gamma_scale=gamma)
        ref = rgp.train(pb, int(cfg["gn_steps"]), initial_point(st.x_dom))
        numbers.append(train_numbers(pb, ref, u, sol))
    return [("state_gap", max(n[0] for n in numbers), run.limits["state_gap"]),
            ("loss_excess", max(n[1] for n in numbers), run.limits["loss_excess"])]
