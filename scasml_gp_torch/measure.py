"""Measure the fused-posterior kernel and the ScaSML solve on one GPU.

    python -m scasml_gp_torch.measure [--out FILE.json]

1. Kernel scaling: CUDA-event time of each main-path specialisation of the
   kernel at d=20 against the bench training set (1000 + 200 rows) for a
   range of evaluation rows n, with pairs per second and the float32 rate
   this implies (flops per pair counted from the kernel source, an FMA as
   2).  The main path calls it at n = 1200 to 4800; larger n shows how much
   of the card those calls leave idle.
2. Solve profile: torch.profiler over one warm ScaSML u_solve(2, 2) on 1200
   points; device time by kernel name, and the device's idle share of the
   solve's wall time (median of 5 solves with the profiler off).
3. Peak device memory allocated by the GP train and by one u_solve.
Needs a CUDA device; prints one line per measurement and writes all of them
to --out as JSON.
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
ROWS = (1200, 2400, 4800, 9600, 19200, 38400, 76800)
# Flops per (x, y) pair in fused_posterior.cu at spatial dimension d,
# counted from the source (FMA = 2; exp = 1): the distance loop 4d, kappa
# and the mean polynomial 25; the gradient adds 20 plus 2(d + 1) for the
# column contraction; the PDE operators add 52.
FLOPS = {
    (False, False): lambda d: 4 * d + 25,
    (True, False): lambda d: 4 * d + 25 + 20 + 2 * (d + 1),
    (False, True): lambda d: 4 * d + 25 + 52,
}
FP32_PEAK = 67e12  # H100 SXM float32 outside the tensor cores, at 700 W


def event_ms(fn, k=7, inner=10, warmup=2):
    """Median over k samples of the mean time of ``inner`` calls of fn, in
    ms from CUDA events, after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(k):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("measure: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    res = {"card": card, "kernel": [], "profile": {}}

    eq = port.GradDependentNonlinear(n_input=D + 1)
    x_dom, x_bdy = eq.generate_data(
        N_DOM, N_BDY, torch.Generator(device=dev).manual_seed(1234), device=dev)
    gp = port.GPGradDependentNonlinear(eq, port.GPConfig(gn_steps=20), device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    gp.GPsolver(x_dom, x_bdy)
    torch.cuda.synchronize()
    res["train_peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
    print(f"[memory] GP train peak allocated {res['train_peak_mib']:.1f} MiB",
          flush=True)
    fused = gp.state.fused_inputs()
    m = fused.y.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    for n in ROWS:
        x = eq.geometry().sample_domain(gen, n, device=dev)
        for flags, flops in FLOPS.items():
            ms = event_ms(lambda: fp.fused_posterior(x, fused, *flags))
            pairs = n * m / (ms * 1e-3)
            row = {"n": n, "want_grad": flags[0], "want_ops": flags[1],
                   "ms": ms, "pairs_per_s": pairs,
                   "tflops": pairs * flops(D) / 1e12,
                   "fp32_peak_share": pairs * flops(D) / FP32_PEAK}
            res["kernel"].append(row)
            print(f"[kernel] n={n} grad={flags[0]:d} ops={flags[1]:d}: "
                  f"{ms:.4f} ms, {pairs:.4g} pairs/s, {row['tflops']:.3f} TFLOP/s "
                  f"({100 * row['fp32_peak_share']:.1f}% of fp32 peak)", flush=True)

    xt_dom, xt_bdy = eq.generate_test_data(
        1000, 200, torch.Generator(device=dev).manual_seed(42), device=dev)
    x_test = torch.cat([xt_dom, xt_bdy])
    solver = port.ScaSML(eq, gp, seed=7)
    torch.cuda.reset_peak_memory_stats(dev)
    solver.u_solve(2, 2, x_test)
    torch.cuda.synchronize()
    res["solve_peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
    print(f"[memory] u_solve(2, 2) peak allocated {res['solve_peak_mib']:.1f} MiB",
          flush=True)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        solver.u_solve(2, 2, x_test)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        solver.u_solve(2, 2, x_test)
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
    kern = sum(r["device_ms"] for r in rows if "fused_posterior_kernel" in r["name"])
    res["profile"] = {"wall_ms_median_of_5": wall_ms, "device_busy_ms": busy,
                      "fused_posterior_ms": kern,
                      "device_launches": sum(r["count"] for r in rows),
                      "device_idle_share": 1.0 - busy / wall_ms, "by_kernel": rows}
    print(f"[profile] u_solve wall {wall_ms:.3f} ms (median of 5, profiler off); "
          f"device busy {busy:.3f} ms in {res['profile']['device_launches']} "
          f"device ops (fused_posterior {kern:.3f} ms); idle share "
          f"{1.0 - busy / wall_ms:.3f}", flush=True)
    for r in rows[:12]:
        print(f"[profile] {r['device_ms']:.4f} ms  x{r['count']}  {r['name'][:90]}",
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
