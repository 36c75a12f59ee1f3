"""Measure the fused-posterior kernel and the ScaSML solve on one GPU.

    python -m scasml_gp_torch.measure [--out FILE.json]
        [--parts kernel,splits,host,solves,tune,train,fit,bf16]

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
   ScaSMLFullHistory u_solve(2, 2, M=3) on 1200 points, each run eagerly
   (the solver's ``_eager()``) and as captured CUDA graphs
   (picard/graphs.py); device time by kernel name, and the device's idle
   share of the solve's wall time (median of 21 solves with the profiler
   off); peak device memory allocated by the GP train, by an eager u_solve
   and by the call that captures the graphs.
5. tune: the flagless d=20 runner's tune (20 candidates, each judged by 3
   full-history ScaSML rollouts; chip_smoke.py phase 5) with every solver
   eager and with captured graphs, in turns (eager, graphed, graphed,
   eager): host-clock seconds and the device memory allocated over the
   start, peak and after.
6. train: torch.profiler over one dense ``GP._train`` (1000 + 200 points,
   20 Newton steps) at d = 20 and d = 100, as it runs (each step's
   Cholesky flags read behind the next step's Hessian) and with every
   step's flags read at once, and over its pieces alone (the Gram, the
   factorization, 20 Newton solves of the 3N x 3N matrix): device busy and
   idle time of both trains, each piece's share of the train's busy time,
   peak memory.
7. fit: one round of ``--fit-ml``'s marginal-likelihood fit at d=20 with
   its 6 restarts: one Adam step looped over the restarts, batched eagerly
   and batched as a replayed CUDA graph; the batched Newton train (and its
   counters) against 6 single trains (busy, idle, peak memory of each); the
   library's batched Cholesky, Cholesky inverse and 3N x 3N solve against
   one call per matrix at the fit's shapes.
8. bf16: at the full-history, Sine d=100 and high_dim d=250 calls
   (BF16_SHAPES; GPs trained on 1000 + 200 rows at d = 20, 100 and 250), the
   bf16-operand variant's device time beside the float32 kernel's on the
   same rows, each against its bound, and the bf16 outputs' largest error
   against the plain bf16 version as a share of the 2e-4 bar.
Needs a CUDA device; prints one line per measurement and writes all of them
to --out as JSON.  Parts 3 and 4 use only the package's public entry points
and ``fused_posterior(x, fused_inputs, want_grad, want_ops)``, so this file
can time another checkout of the package (put that checkout first on
PYTHONPATH and run this file with ``python -P``) for an A/B in one call.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import time

import numpy as np
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
# (caller, d, rows, (want_grad, want_ops)) of the bf16 variant's table in
# PERF.md: the full-history solve's calls at d = 20, the Sine d=100 run's and
# high_dim grad_dep's at d = 250 (with grad+ops on the gradient call's rows)
BF16_SHAPES = tuple(
    (f"{path} {caller}", d, rows, flags)
    for path, d, (n_u, n_grad) in (("full-history", 20, (10800, 3600)),
                                   ("Sine", 100, (10800, 3600)),
                                   ("high_dim", 250, (5400, 1800)))
    for caller, rows, flags in (("g_breve", n_u, (False, False)),
                                ("f_breve", n_grad, (True, False)),
                                ("leaf", n_u, (False, True)),
                                ("grad+ops", n_grad, (True, True))))
PARTS = ("kernel", "splits", "host", "solves", "tune", "train", "fit", "bf16")
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


def profile_solve(name, solve, warm=0, reps=SOLVE_REPS):
    """After ``warm`` untimed calls, peak memory of a call, then the wall
    time (median of ``reps``, profiler off) and a torch.profiler breakdown
    of one warm call of ``solve``."""
    dev = torch.device("cuda", 0)
    for _ in range(warm):
        solve()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) / 2**20
    solve()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    print(f"[memory] {name} peak allocated {peak:.1f} MiB, {peak - base:.1f} MiB over "
          "what was allocated before the call", flush=True)
    walls = []
    for _ in range(reps):
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
    out = {"peak_mib": peak, "peak_over_base_mib": peak - base,
           "wall_ms_median": wall_ms, "wall_ms_all": walls,
           "device_busy_ms": busy,
           "fused_posterior_ms": kern,
           "device_launches": sum(r["count"] for r in rows),
           "device_idle_share": 1.0 - busy / wall_ms, "by_kernel": rows}
    print(f"[profile] {name} wall {wall_ms:.3f} ms (median of {reps}, "
          f"min {min(walls):.3f}, profiler off); "
          f"device busy {busy:.3f} ms in {out['device_launches']} "
          f"device ops (fused_posterior {kern:.3f} ms); idle share "
          f"{out['device_idle_share']:.3f}", flush=True)
    for r in rows[:12]:
        print(f"[profile] {r['device_ms']:.4f} ms  x{r['count']}  {r['name'][:90]}",
              flush=True)
    return out


def profile_solves(eq, gp, x_test) -> dict:
    """``profile_solve`` of the quadrature and the full-history u_solve,
    eager and graphed: keys profile[_full_history][_graphed]."""
    out = {}
    for key, name, solver, solve in (
            ("profile", "u_solve(2, 2)", port.ScaSML(eq, gp, seed=7),
             lambda s: s.u_solve(2, 2, x_test)),
            ("profile_full_history", "full-history u_solve(2, 2, M=3)",
             port.ScaSMLFullHistory(eq, gp, seed=7), lambda s: s.u_solve(2, 2, x_test, M=3))):
        if not hasattr(solver, "_eager"):  # a checkout from before the graphs
            out[key] = profile_solve(name, lambda: solve(solver))
            continue
        with solver._eager():
            out[key] = profile_solve(f"{name} eager", lambda: solve(solver))
        # the first call warms the caches, the measured one captures
        out[f"{key}_graphed"] = profile_solve(f"{name} graphed", lambda: solve(solver),
                                              warm=1)
    return out


@contextlib.contextmanager
def eager_solvers():
    """Every Picard solver eager inside the block (the tuner's judge is a
    solver of its own); a checkout from before the graphs is eager anyway."""
    from scasml_gp_torch.picard.mlp import _PicardBase

    graphed = getattr(_PicardBase, "eager_reason", None)
    if graphed is None:
        yield
        return
    _PicardBase.eager_reason = lambda self: "eager on request"
    try:
        yield
    finally:
        _PicardBase.eager_reason = graphed


def tune_ab(dev) -> list:
    """The flagless d=20 tune, eager and graphed in turns (part 5)."""
    from scasml_gp_torch.harness import runner

    config = port.RunConfig(
        dim=D, num_domain=N_DOM, num_boundary=N_BDY, test_domain=1000, test_boundary=200,
        seed=1234, harness="SimpleUniform",
        picard=port.PicardConfig(variant="full_history", n=2, rho=2, M=3))
    rows = []
    for mode in ("eager", "graphed", "graphed", "eager"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        with eager_solvers() if mode == "eager" else contextlib.nullcontext():
            runner.tuned_config(config, dev)
        torch.cuda.synchronize()
        row = {"mode": mode, "s": time.perf_counter() - t0,
               "peak_mib": (torch.cuda.max_memory_allocated(dev) - before) / 2**20,
               "after_mib": (torch.cuda.memory_allocated(dev) - before) / 2**20}
        rows.append(row)
        print(f"[tune] {mode}: 20 candidates x 3 judge rollouts in {row['s']:.3f} s "
              f"(host clock, synchronized); allocated over the start: peak "
              f"+{row['peak_mib']:.1f} MiB, after +{row['after_mib']:.1f} MiB", flush=True)
    return rows


def profile_train(dev) -> dict:
    """Part 6: one dense ``GP._train`` (1000 + 200 points, 20 Newton steps)
    at d = 20 and 100, as it runs (each step's flags read behind the next
    step's Hessian) and with every step's flags read at once
    (``spd_first_solve``), and its pieces alone: the Gram, the factorization
    and 20 ``spd_first_solve`` calls on a 3N x 3N matrix of the Newton
    step's kind (2 C[z, z] + damping I, positive definite: the Cholesky
    route); each piece's share of the train's device busy time."""
    from scasml_gp_torch.gp.gram import gram_matrix, regularized_factorization
    from scasml_gp_torch.gp.solver import spd_first_solve

    out = {}
    for d in (D, 100):
        eq = port.GradDependentNonlinear(n_input=d + 1)
        x_dom, x_bdy = eq.generate_data(
            N_DOM, N_BDY, torch.Generator(device=dev).manual_seed(1234), device=dev)
        cfg = port.GPConfig(gn_steps=20)
        gp = port.GPGradDependentNonlinear(eq, cfg, device=dev)
        at_once = port.GPGradDependentNonlinear(eq, cfg, device=dev)
        at_once._newton_solve = lambda H, B: spd_first_solve(H, B)[0]
        bdy_g, rhs = eq.g(x_bdy)[:, 0], gp.form.rhs_f(x_dom)
        gamma = torch.tensor(gp.gamma, dtype=torch.float32, device=dev)
        K = gram_matrix(x_dom, x_bdy, gamma, d)
        _, C = regularized_factorization(K, cfg.nugget)
        z = torch.cat([torch.arange(N_DOM), torch.arange(N_DOM + N_BDY, 2 * N_DOM + N_BDY),
                       torch.arange(3 * N_DOM + N_BDY, 4 * N_DOM + N_BDY)]).to(dev)
        H = 2.0 * C[z][:, z] + cfg.damping * torch.eye(3 * N_DOM, device=dev)
        g = torch.randn((3 * N_DOM, 1), generator=torch.Generator(device=dev).manual_seed(5),
                        device=dev)
        parts = {
            "train": lambda: gp._train(x_dom, x_bdy, bdy_g, rhs, gamma, cfg.nugget, 20,
                                       cfg.damping, cfg.grad_tol),
            "train, flags read at once": lambda: at_once._train(
                x_dom, x_bdy, bdy_g, rhs, gamma, cfg.nugget, 20, cfg.damping, cfg.grad_tol),
            "gram": lambda: gram_matrix(x_dom, x_bdy, gamma, d),
            "factorization": lambda: regularized_factorization(K, cfg.nugget),
            "newton solve x20": lambda: [spd_first_solve(H, g) for _ in range(20)],
        }
        res = {k: profile_solve(f"train d={d}: {k}", fn, warm=1, reps=11)
               for k, fn in parts.items()}
        busy = res["train"]["device_busy_ms"]
        res["shares_of_train_busy"] = {k: res[k]["device_busy_ms"] / busy
                                       for k in parts if not k.startswith("train")}
        for k in ("train", "train, flags read at once"):
            print(f"[train] d={d}, {k}: device busy {res[k]['device_busy_ms']:.3f} ms of "
                  f"wall {res[k]['wall_ms_median']:.3f} ms (idle share "
                  f"{res[k]['device_idle_share']:.3f}, idle "
                  f"{res[k]['wall_ms_median'] - res[k]['device_busy_ms']:.3f} ms)", flush=True)
        res["newton_deferred_reads"] = gp.newton_deferred_reads
        res["newton_redos"] = gp.newton_redos
        res["trains"] = gp.newton_solves // 20
        print(f"[train] d={d}: shares of the busy time: "
              + ", ".join(f"{k} {v:.3f}" for k, v in res["shares_of_train_busy"].items())
              + f"; over {res['trains']} trains {res['newton_deferred_reads']} deferred "
              f"reads, {res['newton_redos']} redone", flush=True)
        out[f"d{d}"] = res
    return out


def profile_fit(dev) -> dict:
    """Part 7: one round of the marginal-likelihood fit at d=20 (1000 + 200
    points, the runner's 6 restarts: ridge 0, 3, 10, 30, a ridge-30 seed and
    its jittered twin): one Adam step of all restarts looped (one
    torch.optim.Adam per restart, the fit before the restart axis), batched
    eagerly and batched as a replayed graph; 6 single Newton trains and the
    batched train and its counters; the library's batched Cholesky,
    Cholesky inverse and 3N x 3N solve against one call per matrix
    (gram.per_matrix) at the fit's shapes, with the largest difference of
    their results.  A checkout from
    before the restart axis gives the looped step and the single trains."""
    from scasml_gp_torch.gp import marginal as pm

    eq = port.GradDependentNonlinear(n_input=D + 1)
    x_dom, x_bdy = eq.generate_data(
        N_DOM, N_BDY, torch.Generator(device=dev).manual_seed(1234), device=dev)
    base = port.GPConfig()
    gp, counted = (port.GPGradDependentNonlinear(eq, base, device=dev) for _ in range(2))
    bdy_g, rhs = eq.g(x_bdy)[:, 0], gp.form.rhs_f(x_dom)
    sigma = float(eq.sigma())
    theta0 = [pm._params_to_theta(1.0, 1.0, rs, base.nugget) for rs in (0.0, 3.0, 10.0, 30.0)]
    theta0 += [theta0[-1], theta0[-1] + np.array([0.05, 0.0, 0.0, 0.0], np.float32)]
    theta0 = torch.as_tensor(np.stack(theta0), device=dev)
    R = theta0.shape[0]
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev)
    nlml_of = lambda t, bb: pm._nlml(t, bb, x_dom, x_bdy, sigma, D)  # noqa: E731

    def single_latents(th):
        """One restart's latents b through the single Newton train."""
        with torch.no_grad():
            sol = gp._train(x_dom, x_bdy, bdy_g, rhs, pm._gamma_of(th, sigma, D),
                            pm._theta_to_params(th)[3], base.gn_steps, base.damping,
                            base.grad_tol).sol
            z1, z3, z5 = sol[:N_DOM], sol[N_DOM:2 * N_DOM], sol[2 * N_DOM:]
            return torch.cat([z1, bdy_g, z3, gp.form.F(z1, z3, z5, rhs), z5])

    b = torch.stack([single_latents(t) for t in theta0])
    thetas = [t.clone().requires_grad_(True) for t in theta0]
    opts = [torch.optim.Adam([t], lr=0.08, betas=(0.9, 0.999), eps=1e-8) for t in thetas]

    def looped_step():
        for t, t0, opt, bb in zip(thetas, theta0, opts, b):
            opt.zero_grad(set_to_none=True)
            (nlml_of(t, bb) + 0.5 * 2.0 * torch.sum((t - t0) ** 2)).backward()
            t.grad = torch.where(torch.isfinite(t.grad), t.grad, torch.zeros_like(t.grad)) * mask
            opt.step()

    out = {"restarts": R}
    out["step_looped"] = profile_solve(f"fit: one Adam step, {R} restarts looped",
                                       looped_step, warm=1)
    out["train_single_x6"] = profile_solve(
        f"fit: {R} single Newton trains", lambda: [single_latents(t) for t in theta0], reps=5)
    if not hasattr(pm, "_MapAdam"):  # a checkout from before the restart axis
        return out
    adam = pm._MapAdam(nlml_of, theta0, 1, 0.08, 2.0, mask, graphed=True)
    try:
        adam(theta0, b)  # the eager round: the warm-up
        out["step_batched_eager"] = profile_solve(
            f"fit: one Adam step, {R} restarts batched, eager", adam._step, warm=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adam(theta0, b)  # captures the step, then replays it once
        torch.cuda.synchronize()
        out["capture_call_ms"] = (time.perf_counter() - t0) * 1e3
        out["step_batched_graphed"] = profile_solve(
            f"fit: one Adam step, {R} restarts batched, graphed", adam.graph.replay, warm=1)
    finally:
        adam.close()
    def batched(g):
        return lambda: pm._train_latents(g, theta0, x_dom, x_bdy, bdy_g, rhs, sigma,
                                         base.gn_steps, base)

    out["train_batched"] = profile_solve(
        f"fit: batched Newton train of {R} restarts", batched(gp), reps=5)
    batched(counted)()
    out["newton"] = {k: getattr(counted, k) for k in (
        "newton_solves", "newton_lu_fallbacks", "newton_nopivot_solves",
        "newton_pivoted_solves", "newton_deferred_reads", "newton_redos")}
    print(f"[fit] one Adam step of {R} restarts: looped "
          f"{out['step_looped']['wall_ms_median']:.3f} ms, batched eager "
          f"{out['step_batched_eager']['wall_ms_median']:.3f} ms, graphed "
          f"{out['step_batched_graphed']['wall_ms_median']:.3f} ms (capture call "
          f"{out['capture_call_ms']:.3f} ms); train batched "
          f"{out['train_batched']['wall_ms_median']:.3f} ms, {R} single "
          f"{out['train_single_x6']['wall_ms_median']:.3f} ms; one batched train: "
          + ", ".join(f"{k} {v}" for k, v in out["newton"].items()), flush=True)

    # the libraries' batched routes at the fit's shapes, against the one
    # call per matrix that gram.per_matrix makes
    from scasml_gp_torch.gp import gram

    gamma = pm._gamma_of(theta0, sigma, D)
    K = gram.gram_matrix(x_dom, x_bdy, gamma, D)
    nug = pm._theta_to_params(theta0)[3]
    K = 0.5 * (K + K.mT)
    scale = torch.rsqrt(torch.diagonal(K, dim1=-2, dim2=-1) + nug[:, None])
    eye = torch.eye(K.shape[-1], device=dev)
    M = scale[:, :, None] * (K + nug[:, None, None] * eye) * scale[:, None, :]
    del K
    L = gram.per_matrix(torch.linalg.cholesky_ex, M)[0]
    n3 = 3 * N_DOM
    H = torch.randn((R, n3, n3), generator=torch.Generator(device=dev).manual_seed(6),
                    device=dev) / n3 ** 0.5 + 2.0 * torch.eye(n3, device=dev)
    rhs_h = torch.randn((R, n3, 1), generator=torch.Generator(device=dev).manual_seed(7),
                        device=dev)
    out["library"] = {}
    for name, fn, args in (("cholesky_ex", torch.linalg.cholesky_ex, (M,)),
                           ("cholesky_inverse", torch.cholesky_inverse, (L,)),
                           ("solve_ex", torch.linalg.solve_ex, (H, rhs_h))):
        first = lambda o: o[0] if isinstance(o, tuple) else o  # noqa: E731
        batched = first(fn(*args))
        each = first(gram.per_matrix(fn, *args))
        row = {"shape": list(args[0].shape),
               "batched_ms": event_ms(lambda: fn(*args), k=3, inner=1, warmup=1),
               "per_matrix_ms": event_ms(lambda: gram.per_matrix(fn, *args), k=3, inner=1,
                                         warmup=1),
               "max_rel_diff": float((batched - each).abs().max() / each.abs().max())}
        out["library"][name] = row
        print(f"[fit] {name} {row['shape']}: batched {row['batched_ms']:.3f} ms, "
              f"one call per matrix {row['per_matrix_ms']:.3f} ms (CUDA events); "
              f"results differ by {row['max_rel_diff']:.3g} of the largest entry",
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


def bf16_table(dev):
    """At each BF16_SHAPES call: device ms of the float32 kernel and of the
    bf16 variant on the same rows, their bounds and shares, and the bf16
    outputs against the plain bf16 version (largest |err| over the bar
    2e-4 + 2e-4 |plain|)."""
    from scasml_gp_torch.gp.posterior import posterior_block

    states, rows = {}, []
    gen = torch.Generator(device=dev).manual_seed(5)
    for caller, d, n, flags in BF16_SHAPES:
        if d not in states:
            eq_d = port.GradDependentNonlinear(n_input=d + 1)
            gp_d = port.GPGradDependentNonlinear(eq_d, port.GPConfig(gn_steps=20),
                                                 device=dev)
            gp_d.GPsolver(*eq_d.generate_data(
                N_DOM, N_BDY, torch.Generator(device=dev).manual_seed(1234), device=dev))
            states[d] = (eq_d, gp_d.state)
        eq_d, st = states[d]
        x = eq_d.geometry().sample_domain(gen, n, device=dev)
        m, F = st.x_dom.shape[0] + st.x_bdy.shape[0], d + 1
        row = {"caller": caller, "F": F, "n": n, "m": m, "want_grad": flags[0],
               "want_ops": flags[1]}
        for name, od in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            fused = st.fused_inputs(od)
            ms = event_ms(lambda: fp.fused_posterior(x, fused, *flags), device_bound=True)
            b_ms, _ = bound(n, m, F, *flags, bf16=od == torch.bfloat16)
            row[name] = {"device_ms": ms, "bound_ms": b_ms, "share_of_bound": b_ms / ms,
                         "splits": fp.launch_plan(x, fused, *flags).splits}
        got = fp.fused_posterior(x, st.fused_inputs(torch.bfloat16), *flags)
        ref = posterior_block(x, st.x_dom, st.x_bdy, st.right_vector, st.gamma, d, *flags,
                              operand_dtype=torch.bfloat16)
        row["bf16"]["err_over_bar"] = max(
            float(((a - b).abs() / (2e-4 + 2e-4 * b.abs())).max())
            for a, b in zip(got, ref) if b is not None)
        row["fp32_over_bf16"] = row["fp32"]["device_ms"] / row["bf16"]["device_ms"]
        rows.append(row)
        print(f"[bf16] {caller} F={F} n={n}: float32 {row['fp32']['device_ms']:.4f} ms "
              f"(S={row['fp32']['splits']}, {row['fp32']['share_of_bound']:.3f} of "
              f"{row['fp32']['bound_ms'] * 1e3:.2f} us), bf16 {row['bf16']['device_ms']:.4f} "
              f"ms (S={row['bf16']['splits']}, {row['bf16']['share_of_bound']:.3f} of "
              f"{row['bf16']['bound_ms'] * 1e3:.2f} us), float32 / bf16 "
              f"{row['fp32_over_bf16']:.2f}; bf16 against plain: err / bar "
              f"{row['bf16']['err_over_bar']:.3g}", flush=True)
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
        res.update(profile_solves(eq, gp, x_test))
    if "tune" in parts:
        res["tune"] = tune_ab(dev)
    if "train" in parts:
        res["train"] = profile_train(dev)
    if "fit" in parts:
        res["fit"] = profile_fit(dev)
    if "bf16" in parts:
        res["bf16"] = bf16_table(dev)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
