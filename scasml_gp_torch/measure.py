"""Measure the fused-posterior kernel and the ScaSML solve on one GPU.

    python -m scasml_gp_torch.measure [--out FILE.json] [--parts kernel,splits,host,solves]

1. kernel: CUDA-event time of each specialisation of the kernel against a GP
   trained on 1000 + 200 rows, at d=20 (the bench GP) and at d=100 (F = 101,
   the SineNonlinear path's width), for a range of evaluation rows n, with
   the launch plan's splits, the float32 rate and the share of the bound
   (``bound_ms``: the function's operations in the norm form over the
   float32 peak, or its bytes over the memory rate, whichever is larger).
   The main path calls it at n = 1200 to 10 800; larger n shows where one
   split fills the card.
2. splits: at the main path's ten shapes (MAIN_SHAPES), the kernel's device
   time with the training set forced into each S of SPLITS, beside the S
   that ``fused_posterior.plan`` picks, and the profiler's device time of the
   main and the reduce kernel at the planned S.  This is the measurement
   plan()'s wave model is fitted to.
3. host: the wrapper's host cost per call: the back-to-back time of a
   64-row call of each specialisation against the bench GP, whose device
   time (also given) is a few microseconds.
4. solves: torch.profiler over one warm ScaSML u_solve(2, 2) and one warm
   ScaSMLFullHistory u_solve(2, 2, M=3) on 1200 points; device time by
   kernel name, and the device's idle share of the solve's wall time
   (median of 21 solves with the profiler off); peak device memory
   allocated by the GP train and by each u_solve.
Needs a CUDA device; prints one line per measurement and writes all of them
to --out as JSON.  Parts 3 and 4 use only the package's public entry points
and ``fused_posterior(x, fused_inputs, want_grad, want_ops)``, so this file
can time another checkout of the package (put that checkout first on
PYTHONPATH and run this file with ``python -P``) for an A/B in one call.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import torch

import scasml_gp_torch as port
from scasml_gp_torch.gp import fused_posterior as fp

D, N_DOM, N_BDY = 20, 1000, 200
ROWS = (1200, 2400, 3600, 4800, 9600, 10800, 19200, 38400, 76800)
FLAGS = ((False, False), (True, False), (False, True), (True, True))
# (caller, d, rows, (want_grad, want_ops)) of the posterior calls on the main
# paths: the quadrature solve, the full-history solve and the d=100 Sine run.
MAIN_SHAPES = (
    ("quadrature g_breve", 20, 4800, (False, False)),
    ("quadrature f_breve", 20, 1200, (True, False)),
    ("quadrature leaf", 20, 2400, (False, True)),
    ("full-history g_breve", 20, 10800, (False, False)),
    ("full-history f_breve", 20, 3600, (True, False)),
    ("full-history leaf", 20, 10800, (False, True)),
    ("Sine g_breve", 100, 10800, (False, False)),
    ("Sine f_breve", 100, 3600, (True, False)),
    ("Sine leaf", 100, 10800, (False, True)),
    ("Sine grad+ops", 100, 1200, (True, True)),
)
SPLITS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 19)
PARTS = ("kernel", "splits", "host", "solves")
HOST_ROWS = 64
SOLVE_REPS = 21
FP32_PEAK = 67e12  # H100 SXM float32 outside the tensor cores, at 700 W
BF16_PEAK = 989e12  # H100 SXM bf16 in the tensor cores, dense, at 700 W
HBM_RATE = 3.35e12  # H100 SXM device memory, bytes/s


def pair_flops(F: int, want_grad: bool, want_ops: bool) -> int:
    """Float32 operations per (x, y) pair of the posterior at width F = d + 1,
    in the norm form the plain version and the Pallas kernel use (an FMA as
    2, an exp as 1): x.y and kappa with the mean polynomial 2F + 25; the
    gradient 20 + 2F more (A_sp . Y and A_t . y_t); dt/div/lap 52 more."""
    return (2 * F + 25 + (20 + 2 * F if want_grad else 0)
            + (52 if want_ops else 0))


def bound(n: int, m: int, F: int, want_grad: bool, want_ops: bool, bf16: bool = False):
    """(ms, 'operations' or 'bytes'): the least time an H100 could take for
    one posterior call of n rows against m training rows, the larger of its
    operations over the float32 peak and its bytes (x, the training rows and
    their four weights read once, the outputs written once) over the memory
    rate.  With ``bf16`` (the bf16-operand variant) the x.y product's 2F
    operations a pair have bf16 operands and count at the bf16 tensor-core
    peak; the rest stays float32."""
    flops = pair_flops(F, want_grad, want_ops)
    if bf16:
        ops_ms = n * m * (2 * F / BF16_PEAK + (flops - 2 * F) / FP32_PEAK) * 1e3
    else:
        ops_ms = n * m * flops / FP32_PEAK * 1e3
    outs = 1 + (F if want_grad else 0) + (3 if want_ops else 0)
    nbytes = 4 * (n * F + m * (F + 4) + n * outs)
    bytes_ms = nbytes / HBM_RATE * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def event_ms(fn, k=7, inner=10, warmup=2, device_bound=False):
    """Median over k samples of the mean time of ``inner`` calls of fn, in
    ms from CUDA events, after ``warmup`` untimed calls.  ``device_bound``
    first holds the stream in a sleep kernel (about 0.2 ms a call) so that
    the host has enqueued every call before the first one starts: the time
    is then the device's alone, not the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(k):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if device_bound:
            torch.cuda._sleep(400_000 * inner)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


def profile_solve(name, solve):
    """Peak memory of a first call, then the wall time (median of
    SOLVE_REPS, profiler off) and a torch.profiler breakdown of one warm
    call of ``solve``."""
    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats(dev)
    solve()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    print(f"[memory] {name} peak allocated {peak:.1f} MiB", flush=True)
    walls = []
    for _ in range(SOLVE_REPS):
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        solve()
        torch.cuda.synchronize()
    # device-side events only (kernels, memcpy/memset); the CPU-side aten
    # rows repeat their kernels' time
    rows = [
        {"name": e.key, "count": e.count,
         "device_ms": e.self_device_time_total / 1e3}
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    # both the main kernel and, where a call splits, fused_posterior_reduce
    kern = sum(r["device_ms"] for r in rows if "fused_posterior" in r["name"])
    out = {"peak_mib": peak, "wall_ms_median": wall_ms, "wall_ms_all": walls,
           "device_busy_ms": busy,
           "fused_posterior_ms": kern,
           "device_launches": sum(r["count"] for r in rows),
           "device_idle_share": 1.0 - busy / wall_ms, "by_kernel": rows}
    print(f"[profile] {name} wall {wall_ms:.3f} ms (median of {SOLVE_REPS}, "
          f"min {min(walls):.3f}, profiler off); "
          f"device busy {busy:.3f} ms in {out['device_launches']} "
          f"device ops (fused_posterior {kern:.3f} ms); idle share "
          f"{out['device_idle_share']:.3f}", flush=True)
    for r in rows[:12]:
        print(f"[profile] {r['device_ms']:.4f} ms  x{r['count']}  {r['name'][:90]}",
              flush=True)
    return out


def kernel_scaling(eq, fused, d, dev):
    """Kernel time, plan and share of the bound over ROWS at width d + 1."""
    F, m = d + 1, fused.y.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for n in ROWS:
        x = eq.geometry().sample_domain(gen, n, device=dev)
        for flags in FLAGS:
            ms = event_ms(lambda: fp.fused_posterior(x, fused, *flags),
                          device_bound=True)
            b_ms, b_by = bound(n, m, F, *flags)
            flops = n * m * pair_flops(F, *flags)
            row = {"F": F, "n": n, "m": m, "want_grad": flags[0],
                   "want_ops": flags[1], "ms": ms,
                   "splits": fp.launch_plan(x, fused, *flags).splits,
                   "tflops": flops / (ms * 1e-3) / 1e12, "bound_ms": b_ms,
                   "bound_by": b_by, "share_of_bound": b_ms / ms}
            rows.append(row)
            print(f"[kernel] F={F} n={n} grad={flags[0]:d} ops={flags[1]:d}: "
                  f"{ms:.4f} ms (S={row['splits']}), {row['tflops']:.3f} TFLOP/s, "
                  f"bound {b_ms * 1e3:.2f} us ({b_by}), "
                  f"{100 * row['share_of_bound']:.1f}% of bound", flush=True)
    return rows


def host_cost(eq, fused, dev):
    """Back-to-back and device time of a HOST_ROWS-row call of each
    specialisation: the back-to-back time is the wrapper's host cost."""
    x = eq.geometry().sample_domain(torch.Generator(device=dev).manual_seed(4),
                                    HOST_ROWS, device=dev)
    rows = []
    for flags in FLAGS:
        call = lambda: fp.fused_posterior(x, fused, *flags)  # noqa: E731
        row = {"n": HOST_ROWS, "want_grad": flags[0], "want_ops": flags[1],
               "call_ms": event_ms(call, k=15, inner=50),
               "device_ms": event_ms(call, device_bound=True)}
        rows.append(row)
        print(f"[host] n={HOST_ROWS} grad={flags[0]:d} ops={flags[1]:d}: back to back "
              f"{row['call_ms'] * 1e3:.2f} us a call, device {row['device_ms'] * 1e3:.2f} us",
              flush=True)
    return rows


def split_sweep(states, dev):
    """Device time of each MAIN_SHAPES call against forced splits S."""
    gen = torch.Generator(device=dev).manual_seed(3)
    planned = fp.launch_plan
    rows = []
    for caller, d, n, flags in MAIN_SHAPES:
        eq, fused = states[d]
        x = eq.geometry().sample_domain(gen, n, device=dev)
        p = planned(x, fused, *flags)
        times = {}
        try:
            for S in (S for S in SPLITS if S <= p.tiles):
                fp.launch_plan = lambda *a, S=S: p._replace(splits=S)
                times[S] = event_ms(lambda: fp.fused_posterior(x, fused, *flags),
                                    device_bound=True)
        finally:
            fp.launch_plan = planned
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fp.fused_posterior(x, fused, *flags)
            torch.cuda.synchronize()
        parts = {("reduce" if "reduce" in e.key else "main"):
                 e.self_device_time_total / 10 / 1e3
                 for e in prof.key_averages() if "fused_posterior" in e.key}
        best = min(times, key=times.get)
        rows.append({"caller": caller, "F": d + 1, "n": n, "planned": p.splits,
                     "best": best, "ms_by_splits": times, "profile_ms": parts})
        print(f"[splits] {caller} F={d + 1} n={n}: planned S={p.splits} "
              f"{times.get(p.splits, float('nan')):.4f} ms, best S={best} "
              f"{times[best]:.4f} ms; profiler ms {parts}; by S "
              + " ".join(f"{S}:{t:.4f}" for S, t in times.items()), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated subset of " + ",".join(PARTS))
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        raise SystemExit(f"measure: --parts takes a subset of {PARTS}")
    if not torch.cuda.is_available():
        raise SystemExit("measure: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    res = {"card": card, "package": os.path.dirname(os.path.abspath(port.__file__)),
           "parts": parts}

    gp, states = None, {}
    widths = (D, 100) if {"kernel", "splits"} & set(parts) else (D,)
    for d in widths:
        eq_d = port.GradDependentNonlinear(n_input=d + 1)
        x_dom, x_bdy = eq_d.generate_data(
            N_DOM, N_BDY, torch.Generator(device=dev).manual_seed(1234), device=dev)
        gp_d = port.GPGradDependentNonlinear(eq_d, port.GPConfig(gn_steps=20),
                                             device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        gp_d.GPsolver(x_dom, x_bdy)
        torch.cuda.synchronize()
        if d == D:
            eq, gp = eq_d, gp_d
            res["train_peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
            print(f"[memory] GP train peak allocated {res['train_peak_mib']:.1f} MiB",
                  flush=True)
        states[d] = (eq_d, gp_d.state.fused_inputs())
    if "kernel" in parts:
        res["kernel"] = [row for d in widths
                         for row in kernel_scaling(states[d][0], states[d][1], d, dev)]
    if "splits" in parts:
        res["splits"] = split_sweep(states, dev)
    if "host" in parts:
        res["host"] = host_cost(eq, states[D][1], dev)
    if "solves" in parts:
        xt_dom, xt_bdy = eq.generate_test_data(
            1000, 200, torch.Generator(device=dev).manual_seed(42), device=dev)
        x_test = torch.cat([xt_dom, xt_bdy])
        res["profile"] = profile_solve(
            "u_solve(2, 2)", lambda s=port.ScaSML(eq, gp, seed=7): s.u_solve(2, 2, x_test))
        res["profile_full_history"] = profile_solve(
            "full-history u_solve(2, 2, M=3)",
            lambda s=port.ScaSMLFullHistory(eq, gp, seed=7): s.u_solve(2, 2, x_test, M=3))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
