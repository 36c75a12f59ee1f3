"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py          (from the repository root, on a CUDA host)

Phases, each printing its own lines:
  1. device:  nvidia-smi's name and power limit; TF32 must be off.
  2. build:   nvcc builds scasml_gp_torch/csrc/*.cu for sm_90a.
  3. kernel:  the fused-posterior CUDA kernel against its plain PyTorch
              version (posterior_block) on the bench GP's training set and
              trained weights (d=20, N=1000, Nb=200), for
              n in {1200, 2400, 4800, 1337}, all four (want_grad, want_ops)
              specialisations and two gammas, at rtol = atol = 2e-4; CUDA-event
              times of kernel and plain at the main path's three
              specialisations and shapes.
  4. main:    the bench workload on the port: GradDependentNonlinear d=20,
              GP trained on 1000 + 200 seeded points (gn_steps=20), then
              ScaSML(eq, gp).u_solve(2, 2, x_test) on 1000 + 200 test points;
              train and solve times, rel-L2 of GP and ScaSML, and the kernel
              launches of one u_solve.
  5. runner:  the flagless runner path users run (python -m
              scasml_gp_torch.harness.runner --variant full_history): the
              runner's tune (20 candidates, each judged by 3 full-history
              ScaSML rollouts), then run() through SimpleUniform at d=20,
              1000 + 200 train and test points, seed 1234, n = rho = 2,
              M = 3, into results/smoke_runner/; tune, train and solve
              times, CUDA-event time of one ScaSMLFullHistory
              u_solve(2, 2, M=3), kernel launches of each part, rel-L2 of
              GP, MLP and SCaSML; the kernel against its plain version with
              the tuned weights at the full-history path's shapes.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero; there
is no CPU path.  Imports neither JAX nor the JAX package.
"""

import json
import math
import os
import subprocess
import sys
import time

D, N_DOM, N_BDY = 20, 1000, 200
N_TEST_DOM, N_TEST_BDY = 1000, 200
RTOL = ATOL = 2e-4
ROWS = (1200, 2400, 4800, 1337)
FLAGS = ((False, False), (True, False), (False, True), (True, True))
# (want_grad, want_ops) -> (caller on the main path, rows it evaluates)
MAIN_SPECS = {
    (False, False): ("g_breve", 4800),
    (True, False): ("f_breve", 1200),
    (False, True): ("leaf", 2400),
}
# One u_solve(2, 2) makes 19 posterior calls in the rollout and 1 for u_hat:
# g_breve 1 + 3 terminal passes (+ u_hat), f_breve 3, leaf 3 + 9.
EXPECTED_LAUNCHES = {(False, False): 5, (True, False): 3, (False, True): 12}
REPLACES = "scripts/pallas_posterior.py:226"

# Phase 5.  Posterior calls (kernel launches) by specialisation, pinned on
# the CPU by tests/test_torch_full_history.py and tests/test_torch_harness.py:
# a judge rollout uz_solve(2, M=8) makes g_breve 2, f_breve 1, leaf 2; the
# tune makes one per candidate and validation set.
FH_SPECS = {  # full-history u_solve(2, 2, M=3) on 1200 points: (caller, rows)
    (False, False): ("g_breve", 10800),
    (True, False): ("f_breve", 3600),
    (False, True): ("leaf", 10800),
}
TUNE_CANDIDATES, JUDGE_VAL_SETS = 20, 3
JUDGE_LAUNCHES = {(False, False): 2, (True, False): 1, (False, True): 2}
EXPECTED_TUNE_LAUNCHES = {k: v * TUNE_CANDIDATES * JUDGE_VAL_SETS
                          for k, v in JUDGE_LAUNCHES.items()}
# SimpleUniform: the train's and the test set's predict, and the PDE loss,
# around one ScaSMLFullHistory u_solve.
EXPECTED_FH_SOLVE_LAUNCHES = {(False, False): 3, (True, False): 1, (False, True): 2}
EXPECTED_RUN_LAUNCHES = {(False, False): 5, (True, False): 1, (False, True): 3}
RUN_DIR = "results/smoke_runner"
# metrics.json of SimpleUniform: the JAX package's key tree
SOLVERS = ("GP", "MLP", "SCaSML")
METRICS_KEYS = {
    "metrics": {s: {"L1": None, "L2": None, "rel_L2": None} for s in SOLVERS},
    "t_tests": {p: {"t": None, "p": None}
                for p in ("GP_vs_SCaSML", "MLP_vs_SCaSML")},
    "real_sol_L2": None,
    "valid_count": None,
    "times": {k: None for k in SOLVERS + ("GP_train",)},
    "PDE_loss": {"mean": None, "std": None},
    "diff_stats": {p: {k: None for k in ("positive_count", "negative_count",
                                          "positive_sum", "negative_sum")}
                   for p in ("GP_vs_SCaSML", "MLP_vs_SCaSML")},
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def rel_l2(pred, exact):
    pred, exact = pred.reshape(-1).double(), exact.reshape(-1).double()
    return float((pred - exact).norm() / exact.norm())


def key_tree(obj):
    if isinstance(obj, dict):
        return {k: key_tree(v) for k, v in obj.items()}
    return None


def leaves(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from leaves(v)
    else:
        yield obj


def by_flags_str(d):
    return {f"{k[0]:d}{k[1]:d}": v for k, v in sorted(d.items())}


def compare_kernel(x, fused, x_dom, x_bdy, r, gamma, d, flags, what):
    """Launch the kernel and its plain version on x; raise on any element
    outside rtol = atol = 2e-4; return the max abs error."""
    import torch

    from scasml_gp_torch.gp import fused_posterior as fp
    from scasml_gp_torch.gp.posterior import posterior_block

    got = fp.fused_posterior(x, fused, *flags)
    ref = posterior_block(x, x_dom, x_bdy, r, gamma, d, *flags)
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, b in zip(ref._fields, got, ref):
        check((a is None) == (b is None), f"{name} presence differs")
        if b is None:
            continue
        check(a.shape == b.shape, f"{name} shape {a.shape} != {b.shape}")
        check(bool(torch.isfinite(a).all()), f"{name} not finite")
        err = (a - b).abs()
        check(not bool((err > ATOL + RTOL * b.abs()).any()),
              f"kernel != plain for {name} ({what}, want_grad={flags[0]}, "
              f"want_ops={flags[1]}): max err {float(err.max()):.3g}")
        worst = max(worst, float(err.max()))
    return worst


def runner_phase(dev, smi):
    """Phase 5: the flagless full-history runner path; returns the kernel
    records it adds to the JSON line."""
    import torch

    import scasml_gp_torch as port
    from scasml_gp_torch.gp import fused_posterior as fp
    from scasml_gp_torch.gp.posterior import posterior_block
    from scasml_gp_torch.harness import runner
    from scasml_gp_torch.measure import event_ms

    config = port.RunConfig(
        dim=D, num_domain=N_DOM, num_boundary=N_BDY, test_domain=N_TEST_DOM,
        test_boundary=N_TEST_BDY, seed=1234, harness="SimpleUniform",
        save_path=RUN_DIR,
        picard=port.PicardConfig(variant="full_history", n=2, rho=2, M=3),
    )
    torch.cuda.synchronize()
    fp.reset_launches()
    t0 = time.perf_counter()
    config, tuned = runner.tuned_config(config, dev)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    tune_launches = dict(fp.launches_by_flags)
    print(f"[runner] {smi}; tune: {len(tuned.table)} candidates in "
          f"{tune_s:.3f} s; winner ridge_scale={config.gp.ridge_scale} "
          f"gamma_scale={config.gp.gamma_scale} score {tuned.score:.6g}",
          flush=True)
    for cfg, score in tuned.table:
        print(f"[runner] score ridge_scale={cfg.ridge_scale:g} "
              f"gamma_scale={cfg.gamma_scale:g}: {score:.6g}", flush=True)
    check(len(tuned.table) == TUNE_CANDIDATES,
          f"{len(tuned.table)} tune candidates, expected {TUNE_CANDIDATES}")
    check(all(math.isfinite(sc) for _, sc in tuned.table),
          "a tune score is not finite")

    fp.reset_launches()
    runner.run(config, device=dev, make_plots=False)
    torch.cuda.synchronize()
    run_launches = dict(fp.launches_by_flags)
    path = os.path.join(RUN_DIR, "GradDependentNonlinear", f"{D}d",
                        "full_history", "SimpleUniform", "metrics.json")
    with open(path) as fh:
        written = json.load(fh)
    check(key_tree(written) == METRICS_KEYS,
          f"metrics.json keys {key_tree(written)} != the JAX package's")
    check(all(isinstance(v, (int, float)) and math.isfinite(v)
              for v in leaves(written)), "metrics.json holds a non-finite value")
    rel = {k: written["metrics"][k]["rel_L2"] for k in SOLVERS}
    times = written["times"]
    print(f"[runner] {smi}; GP train {times['GP_train']:.4f} s; solves: "
          f"GP {times['GP']:.4f} s, MLP {times['MLP']:.4f} s, "
          f"SCaSML {times['SCaSML']:.4f} s (host clock, first call)", flush=True)
    print(f"[runner] rel-L2: GP {rel['GP']:.6f}, MLP {rel['MLP']:.6f}, "
          f"SCaSML {rel['SCaSML']:.6f}", flush=True)

    # The run's solvers again, on the harness's training points, for the
    # solve's device time and the kernel check with the tuned weights.
    eq, gp, _, sca = runner.build_solvers(config, dev)
    gen = torch.Generator(device=dev).manual_seed(config.seed)
    x_dom, x_bdy = eq.generate_data(N_DOM, N_BDY, gen, device=dev)
    gp.GPsolver(x_dom, x_bdy)
    gen_test = torch.Generator(device=dev).manual_seed(config.seed + 1)
    x_test = torch.cat(eq.generate_test_data(N_TEST_DOM, N_TEST_BDY, gen_test,
                                             device=dev))
    sca.u_solve(2, 2, x_test, M=3)  # warm-up
    torch.cuda.synchronize()
    fp.reset_launches()
    u = sca.u_solve(2, 2, x_test, M=3)
    torch.cuda.synchronize()
    solve_launches = dict(fp.launches_by_flags)
    check(u.shape == (x_test.shape[0], 1) and bool(torch.isfinite(u).all()),
          "full-history u_solve output")
    solve_ms = event_ms(lambda: sca.u_solve(2, 2, x_test, M=3), k=5, inner=1,
                        warmup=1)
    print(f"[runner] {smi}; ScaSMLFullHistory u_solve(2, 2, M=3) on "
          f"{x_test.shape[0]} points: {solve_ms:.3f} ms median of 5 "
          f"(CUDA events)", flush=True)
    print(f"[runner] kernel launches: tune {by_flags_str(tune_launches)}, "
          f"run {by_flags_str(run_launches)}, one u_solve "
          f"{by_flags_str(solve_launches)}", flush=True)

    st = gp.state
    fused = st.fused_inputs()
    gen_x = torch.Generator(device=dev).manual_seed(5)
    records = {}
    for flags, (caller, n) in FH_SPECS.items():
        x = eq.geometry().sample_domain(gen_x, n, device=dev)
        err = compare_kernel(x, fused, st.x_dom, st.x_bdy, st.right_vector,
                             st.gamma, D, flags, f"tuned full-history GP, n={n}")
        k_ms = event_ms(lambda: fp.fused_posterior(x, fused, *flags))
        p_ms = event_ms(lambda: posterior_block(
            x, st.x_dom, st.x_bdy, st.right_vector, st.gamma, D, *flags))
        records[flags] = {"rows": n, "max_abs_err": err, "ms": k_ms,
                          "plain_ms": p_ms}
        print(f"[runner] {smi}; kernel {caller} (want_grad={flags[0]:d}, "
              f"want_ops={flags[1]:d}) n={n}, tuned weights: kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, max abs err {err:.3g}",
              flush=True)

    check(tune_launches == EXPECTED_TUNE_LAUNCHES,
          f"tune launches {tune_launches} != {EXPECTED_TUNE_LAUNCHES}")
    check(run_launches == EXPECTED_RUN_LAUNCHES,
          f"run launches {run_launches} != {EXPECTED_RUN_LAUNCHES}")
    check(solve_launches == EXPECTED_FH_SOLVE_LAUNCHES,
          f"u_solve launches {solve_launches} != {EXPECTED_FH_SOLVE_LAUNCHES}")
    check(rel["GP"] < 0.06, f"tuned GP rel-L2 {rel['GP']} not below 0.06")
    check(rel["SCaSML"] < rel["GP"],
          f"SCaSML rel-L2 {rel['SCaSML']} not below GP {rel['GP']}")
    check(rel["MLP"] < 0.30, f"MLP rel-L2 {rel['MLP']} not below 0.30")
    for flags, rec in records.items():
        rec["launches"] = {"tune": tune_launches.get(flags, 0),
                           "run": run_launches.get(flags, 0),
                           "u_solve": solve_launches.get(flags, 0)}
    return records


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "runs only on a GPU", file=sys.stderr)
        return 1

    import scasml_gp_torch as port
    from scasml_gp_torch.gp import fused_posterior as fp
    from scasml_gp_torch.gp.kernels import kernel_gammas
    from scasml_gp_torch.gp.posterior import posterior_block
    from scasml_gp_torch.measure import event_ms
    from scasml_gp_torch.utils import build

    dev = torch.device("cuda", 0)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul is on")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; TF32 off", flush=True)

    # 2. build
    t0 = time.perf_counter()
    path = build.build()
    build.load_library()
    print(f"[build] {path} in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}", flush=True)

    # The bench workload's GP, trained once here: its representer weights
    # are the values the kernel meets on the main path.  (Random N(0, 1)
    # weights make outputs of size 1e3 that cancel to near zero at some
    # rows, where any two float32 summation orders differ by more than the
    # elementwise 2e-4 bar.)
    eq = port.GradDependentNonlinear(n_input=D + 1)
    gen_train = torch.Generator(device=dev).manual_seed(1234)
    x_dom, x_bdy = eq.generate_data(N_DOM, N_BDY, gen_train, device=dev)
    gp = port.GPGradDependentNonlinear(eq, port.GPConfig(gn_steps=20), device=dev)
    gp.GPsolver(x_dom, x_bdy)
    r = gp.state.right_vector

    # 3. kernel against its plain version
    gen = torch.Generator(device=dev).manual_seed(0)
    gammas = {
        "isotropic": kernel_gammas(eq.sigma(), D),
        "separable+ridge": kernel_gammas(eq.sigma(), D, time_scale=0.6,
                                         ridge_scale=5.0),
    }
    geom = eq.geometry()
    xs = {n: geom.sample_domain(gen, n, device=dev) for n in ROWS}
    max_err = {f: 0.0 for f in FLAGS}
    for gname, gamma in gammas.items():
        fused = fp.prepare_inputs(x_dom, x_bdy, r, gamma, D)
        for n, x in xs.items():
            for flags in FLAGS:
                err = compare_kernel(x, fused, x_dom, x_bdy, r, gamma, D, flags,
                                     f"{gname}, n={n}")
                max_err[flags] = max(max_err[flags], err)
    print(f"[kernel] 2 gammas x {len(ROWS)} row counts x 4 specialisations "
          f"agree with posterior_block at rtol=atol={RTOL}; max abs err by "
          f"(want_grad, want_ops): {by_flags_str(max_err)}", flush=True)

    gamma = gammas["isotropic"]
    fused = fp.prepare_inputs(x_dom, x_bdy, r, gamma, D)
    times = {}
    for flags, (caller, n) in MAIN_SPECS.items():
        x = xs[n]
        k_ms = event_ms(lambda: fp.fused_posterior(x, fused, *flags))
        p_ms = event_ms(lambda: posterior_block(
            x, x_dom, x_bdy, r, gamma, D, *flags))
        times[flags] = (k_ms, p_ms)
        print(f"[kernel] {caller} (want_grad={flags[0]:d}, want_ops={flags[1]:d}) "
              f"n={n}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms", flush=True)

    # 4. main path: the bench workload
    train_ms = event_ms(lambda: gp.GPsolver(x_dom, x_bdy), k=5,
                        inner=1, warmup=0)
    loss = gp.state.loss_history
    check(bool(torch.isfinite(loss).all()) and bool(torch.isfinite(
        gp.state.right_vector).all()), "GP training gave non-finite values")
    print(f"[main] GP train (N={N_DOM}, Nb={N_BDY}, 20 Newton steps): "
          f"{train_ms:.2f} ms median of 5; loss {float(loss[0]):.6g} -> "
          f"{float(loss[-1]):.6g}", flush=True)

    gen_test = torch.Generator(device=dev).manual_seed(42)
    xt_dom, xt_bdy = eq.generate_test_data(N_TEST_DOM, N_TEST_BDY, gen_test,
                                           device=dev)
    x_test = torch.cat([xt_dom, xt_bdy], dim=0)
    exact = eq.exact_solution(x_test)
    e_gp = rel_l2(gp.predict(x_test), exact)

    solver = port.ScaSML(eq, gp, seed=7)
    solver.u_solve(2, 2, x_test)  # warm-up
    torch.cuda.synchronize()
    fp.reset_launches()
    u = solver.u_solve(2, 2, x_test)
    torch.cuda.synchronize()
    launches = fp.launches
    by_flags = dict(fp.launches_by_flags)
    check(u.shape == (N_TEST_DOM + N_TEST_BDY, 1), f"u_solve shape {u.shape}")
    check(bool(torch.isfinite(u).all()), "u_solve output not finite")
    e_sca = rel_l2(u, exact)
    solve_ms = event_ms(lambda: solver.u_solve(2, 2, x_test), k=5,
                        inner=1, warmup=1)
    print(f"[main] GP rel-L2 {e_gp:.6f}; ScaSML rel-L2 {e_sca:.6f}", flush=True)
    print(f"[main] ScaSML u_solve(2, 2) on {x_test.shape[0]} points: "
          f"{solve_ms:.2f} ms median of 5", flush=True)
    print(f"[main] kernel launches in one u_solve: {launches} "
          f"{by_flags_str(by_flags)}", flush=True)
    check(launches > 0, "the main path launched no kernel")
    check(launches == sum(EXPECTED_LAUNCHES.values()),
          f"{launches} launches, expected {sum(EXPECTED_LAUNCHES.values())}")
    check(by_flags == EXPECTED_LAUNCHES,
          f"launches by specialisation {by_flags} != {EXPECTED_LAUNCHES}")
    check(0.10 <= e_gp <= 0.20, f"GP rel-L2 {e_gp} outside [0.10, 0.20]")
    check(e_sca < e_gp and e_sca < 0.10,
          f"ScaSML rel-L2 {e_sca} not below GP {e_gp} and 0.10")

    # 5. the flagless full-history runner path
    fh = runner_phase(dev, smi)

    kernels = [
        {
            "name": f"fused_posterior[{caller}: want_grad={f[0]:d} want_ops={f[1]:d}]",
            "route": "cuda",
            "source": "scasml_gp_torch/csrc/fused_posterior.cu",
            "replaces": REPLACES,
            "launches": by_flags.get(f, 0),
            "max_abs_err": max_err[f],
            "ms": times[f][0],
            "plain_ms": times[f][1],
            "full_history": fh[f],
        }
        for f, (caller, _) in MAIN_SPECS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
