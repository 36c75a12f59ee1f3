"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py          (from the repository root, on a CUDA host)

Phases, each printing its own lines:
  1. device:  nvidia-smi's name and power limit; TF32 must be off.
  2. build:   nvcc builds scasml_gp_torch/csrc/*.cu for sm_90a.
  3. kernel:  the fused-posterior CUDA kernel against its plain PyTorch
              version (posterior_block) on the bench GP's training set and
              trained weights (d=20, N=1000, Nb=200), for
              n in {1200, 2400, 4800, 1337}, all four (want_grad, want_ops)
              specialisations and two gammas, at rtol = atol = 2e-4, each
              case launched twice with bitwise equal results; CUDA-event
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
  6. extra:   the three other PDE families at d=100 through the runner's
              solvers and SimpleUniform (1000 + 200 train and test points,
              seed 1234, n = rho = 2, M = 3, full history, into
              results/smoke_extra/): SineNonlinear flagless (tuned; the
              kernel at F = 101 against posterior_block for all four
              specialisations), HJB with the Cole-Hopf mixture surrogate,
              HJB with the coarse rbf surrogate (the guard's repair branch;
              its float32 terminal fit against a float64 one) and
              AllenCahn against the MC oracle.  Tune, train, solve and
              oracle times, kernel launches (zero on the HJB and
              Allen-Cahn paths), rel-L2 of GP, MLP and SCaSML, the guard's
              lambda and ladder, and per-call times of the semigroup
              surrogates' feature blocks.
  7. fit-ml:  the runner's --fit-ml path at d=20 (runner.fitted_config: the
              4-candidate ridge grid, then the marginal-likelihood fit, 3
              rounds of 6 restarts x 30 Adam steps, each candidate judged by
              3 full-history ScaSML rollouts; then run() through
              SimpleUniform, 1000 + 200 train and test points, seed 1234,
              n = rho = 2, M = 3, into results/smoke_fitml/): grid, fit,
              judge and round times, the NLML history, the candidate table,
              the shipped config, kernel launches of grid, fit and run, and
              rel-L2 of GP, MLP and SCaSML.
  8. sweeps:  ConvergenceRate, InferenceScaling, SimpleScaling and
              ComputingBudget through run() with phase 5's tuned config
              (full history, M = 3, seed 1234, each harness's defaults,
              into results/smoke_sweeps/): wall times, rows, the key trees
              against the JAX package's committed metrics.json, the
              evaluation counters, and the kernel against posterior_block
              at the sweeps' new shapes (a 100 + 20 point GP; M = 15).
  9. large-n: (a) the dense and the distributed (dual-CG) trainer on one
              problem both take (d=20, 2000 + 200 points, untuned): train
              times, CG iterations, final residuals, loss histories, and
              their predictions at 1200 points within rel 2e-2; (b) the
              users' large-N path, runner --dim 20 --variant full_history
              --num-domain 8192 --num-boundary 512, flagless (the tune's 20
              candidates and the run's train through the distributed
              trainer, none through the dense one; into
              results/smoke_large_n/): Gram assembly, per-candidate train
              and tune times, GEMVs with K against their bandwidth bound, CG
              iterations, final residuals, peak device memory, kernel
              launches, rel-L2 of GP (< 0.03), MLP and SCaSML (< GP), and
              the kernel against posterior_block against 8 704 training rows.
  10. serve:  phase 5's tuned surrogate through save_surrogate /
              load_surrogate (results/smoke_serve/) and a SurrogateServer
              (buckets 256, 1024, 4096; full-history ScaSML): requests of 33,
              1000 and 5000 rows through Python and serve_http on 127.0.0.1,
              predict and gradient within 2e-4 of the direct calls, HTTP
              equal to Python, two identical /solve requests bitwise equal,
              stats() counted; p50 latency per endpoint and bucket over 20
              requests.
  11. debug:  a full-history u_solve(2, 2, M=3) with debug_checks=True
              bitwise equal to the unchecked one under the same seed, a NaN
              input row raising the port's error naming an aten op, and the
              slowdown.
  12. mesh:   (a) a world of one process over NCCL with a 1 x 1 mesh:
              parallel.make_sharded_train_and_solve on the bench workload
              (quadrature ScaSML (2, 2), 20 Newton steps) bitwise equal to
              the unsharded train, rollout and u_hat; (b) two processes on
              cuda:0 over gloo (NCCL refuses two ranks on one card): phase
              10's tuned surrogate, ScaSMLFullHistory u_solve(2, 2, M=3) on
              1200 points on a 2 x 1 mesh (the batch split; rtol 1e-4,
              atol 1e-5 against world 1) and on a 1 x 2 mesh (the training
              rows split; rtol 2e-3, atol 2e-4), and one dense train with
              the Gram's rows split, each rank's kernel launches.
  13. bf16:   the bf16-operand kernel variant against posterior_block with
              bf16 operands, all four specialisations, at the bench GP's
              and at phase 5's full-history shapes with trained weights, at
              2e-4, two launches bitwise equal; its distance from the
              float32 kernel; the flagless full-history runner with --bf16
              (into results/smoke_bf16/) against phase 5's float32 run
              (|GP_bf16 - GP_fp32| < 0.25 GP_fp32, SCaSML < GP), its bf16
              kernel launches.
  14. parity: laplacian='subset' with and without parity_fp16 on the bench
              points (the biased Gram, the fp64 eigh on the card, Newton):
              times, GP and quadrature ScaSML (2, 2) rel-L2; terminal_crn
              ScaSML and MLP, and MLP with terminal_crn, reference_semantics
              and float16 paths, on 1200 points, beside the JAX package's
              figures in reports/quadrature_parity.json.
  15. drivers: the experiment drivers of scasml_gp_torch.scripts through
              their mains (into results/smoke_drivers/): one run_all row
              (GradDependentNonlinear d=20 full history RepeatedExperiment,
              flagless: the tune, then 10 repetitions; a row holding "error"
              fails the phase), summarize_campaign on its summary,
              throughput at d=100 (2 reps), high_dim grad_dep at d=250
              (untuned GP on 1000 + 200 points, 500 + 100 test points);
              rel-L2, times and kernel launches of each; then the kernel at
              F = 251 against posterior_block for all four specialisations,
              on the GP that high_dim trained and the rows of the largest
              call of each that its run launched (grad+ops, which it does
              not launch, on the gradient call's rows; 2e-4, two launches
              bitwise equal), both also against a float64 posterior_block.
Kernel times are CUDA-event times of calls back to back as a caller sees
them (``ms`` and ``plain_ms``, the host's launch cost included, as in every
earlier version of this script) and with the stream held until every call is
enqueued (``device_ms``, the device's time alone).  Each kernel record gives
the bound (``scasml_gp_torch.measure.bound``: the call's float32 operations
in the norm form over the 67 TFLOP/s peak, with the bf16 variant's x.y
product over the 989 TFLOP/s bf16 peak, or its bytes over 3.35 TB/s,
whichever is larger) and the kernel's share of it, ``bound_ms /
device_ms``; no single PyTorch call computes the posterior, so
``library_ms`` is null.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero; there
is no CPU path.  Imports neither JAX nor the JAX package.
"""

import json
import math
import os
import re
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
    """Every value of a metrics dict, through nested dicts and lists."""
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, list):
        for v in obj:
            yield from leaves(v)
    else:
        yield obj


def by_flags_str(d):
    return {f"{k[0]:d}{k[1]:d}": v for k, v in sorted(d.items())}


def compare_kernel(x, fused, x_dom, x_bdy, r, gamma, d, flags, what,
                   repeat=False):
    """Launch the kernel and its plain version (with the operand dtype of
    ``fused``) on x; raise on any element outside rtol = atol = 2e-4 (and
    with ``repeat`` unless a second launch gives the same bits); return the
    max abs error of each output."""
    import torch

    from scasml_gp_torch.gp import fused_posterior as fp
    from scasml_gp_torch.gp.posterior import posterior_block

    got = fp.fused_posterior(x, fused, *flags)
    again = fp.fused_posterior(x, fused, *flags) if repeat else got
    ref = posterior_block(x, x_dom, x_bdy, r, gamma, d, *flags,
                          operand_dtype=fused.operand_dtype)
    torch.cuda.synchronize()
    worst = {}
    for name, a, a2, b in zip(ref._fields, got, again, ref):
        check(a2 is None or torch.equal(a, a2),
              f"two launches differ in {name} ({what}, flags {flags})")
        check((a is None) == (b is None), f"{name} presence differs")
        if b is None:
            continue
        check(a.shape == b.shape, f"{name} shape {a.shape} != {b.shape}")
        check(bool(torch.isfinite(a).all()), f"{name} not finite")
        err = (a - b).abs()
        check(not bool((err > ATOL + RTOL * b.abs()).any()),
              f"kernel != plain for {name} ({what}, want_grad={flags[0]}, "
              f"want_ops={flags[1]}): max err {float(err.max()):.3g}")
        worst[name] = float(err.max())
    return worst


def kernel_record(x, fused, flags, plain, errs):
    """Times of the kernel (back to back and device) and of ``plain`` (back
    to back) on x, with the call's bound and the kernel's share of it;
    ``errs`` is compare_kernel's max abs error by output."""
    from scasml_gp_torch.gp import fused_posterior as fp
    from scasml_gp_torch.measure import bound, event_ms

    def kernel():
        return fp.fused_posterior(x, fused, *flags)

    import torch

    device_ms = event_ms(kernel, device_bound=True)
    b_ms, b_by = bound(x.shape[0], fused.y.shape[0], fused.dim + 1, *flags,
                       bf16=fused.operand_dtype == torch.bfloat16)
    return {"rows": x.shape[0], "F": fused.dim + 1,
            "splits": fp.launch_plan(x, fused, *flags).splits,
            "max_abs_err": max(errs.values()), "max_abs_err_by_output": errs,
            "ms": event_ms(kernel), "device_ms": device_ms,
            "plain_ms": event_ms(plain), "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / device_ms, "library_ms": None}


def describe(rec):
    return (f"kernel {rec['ms']:.4f} ms back to back (device {rec['device_ms']:.4f}; "
            f"S={rec['splits']}), plain {rec['plain_ms']:.4f} ms, bound "
            f"{1e3 * rec['bound_ms']:.2f} us ({rec['bound_by']}), share of it on "
            f"the device {rec['share_of_bound']:.3f}, max abs err {rec['max_abs_err']:.3g} ("
            + ", ".join(f"{k} {v:.3g}" for k, v in rec["max_abs_err_by_output"].items())
            + ")")


def runner_phase(dev, smi):
    """Phase 5: the flagless full-history runner path; returns the kernel
    records it adds to the JSON line, the tuned config and the tuned GP
    trained on the harness's points."""
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
        records[flags] = kernel_record(x, fused, flags, lambda: posterior_block(
            x, st.x_dom, st.x_bdy, st.right_vector, st.gamma, D, *flags), err)
        print(f"[runner] {smi}; kernel {caller} (want_grad={flags[0]:d}, "
              f"want_ops={flags[1]:d}) n={n}, tuned weights: "
              f"{describe(records[flags])}", flush=True)

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
    return records, config, gp


EXTRA_D = 100
EXTRA_DIR = "results/smoke_extra"
EXTRA_ROWS = {(False, False): 10800, (True, False): 3600, (False, True): 10800,
              (True, True): 1200}


def extra_run(config, dev, make_gp=None):
    """What runner.run(config) does, on solvers kept here so that the
    guard's lambda and ladder can be read afterwards.  ``make_gp(eq)``
    replaces the runner's surrogate, and ScaSML is rebuilt on it."""
    import torch

    from scasml_gp_torch.gp import fused_posterior as fp
    from scasml_gp_torch.harness import runner
    from scasml_gp_torch.picard.scasml import ScaSMLFullHistory

    eq, gp, mlp, sca = runner.build_solvers(config, dev)
    if make_gp is not None:
        gp = make_gp(eq)
        sca = ScaSMLFullHistory(eq, gp, batch_chunk=config.picard.batch_chunk)
    harness = runner.HARNESSES[config.harness](eq, gp, mlp, sca)
    torch.cuda.synchronize()
    fp.reset_launches()
    result = harness.test(runner.run_dir(config),
                          **runner.harness_kwargs(config, make_plots=False))
    torch.cuda.synchronize()
    return result, dict(fp.launches_by_flags), eq, gp, sca


def report_run(tag, smi, result, launches, sca, tune_s=None):
    """Print one run's times, rel-L2, launches and guard; return rel-L2."""
    rel = {k: result["metrics"][k]["rel_L2"] for k in SOLVERS}
    t = result["times"]
    tune = f"tune {tune_s:.3f} s; " if tune_s is not None else ""
    print(f"[extra] {tag}: {smi}; {tune}GP train {t['GP_train']:.4f} s; "
          f"solves GP {t['GP']:.4f} s, MLP {t['MLP']:.4f} s, SCaSML "
          f"{t['SCaSML']:.4f} s (host clock, first call)", flush=True)
    ladder = ", ".join(f"(n={c[0]}, {c[1]}): {lam:.4f}"
                       for c, lam in sca.last_ladder)
    print(f"[extra] {tag}: rel-L2 GP {rel['GP']:.6f}, MLP {rel['MLP']:.6f}, "
          f"SCaSML {rel['SCaSML']:.6f}; kernel launches "
          f"{by_flags_str(launches)}; guard {sca.variance_guard}, last_lambda "
          f"{sca.last_lambda}, ladder [{ladder}]", flush=True)
    check(all(math.isfinite(v) for v in leaves(result["metrics"])),
          f"{tag}: a metric is not finite")
    return rel


def extra_phase(dev, smi):
    """Phase 6: SineNonlinear, HJB (mixture and coarse rbf) and AllenCahn
    at d=100; returns the Sine kernel records for the JSON line."""
    import torch

    import scasml_gp_torch as port
    from scasml_gp_torch.gp import fused_posterior as fp
    from scasml_gp_torch.gp.cole_hopf import GPHJBColeHopf, sq_dists, terminal_fit
    from scasml_gp_torch.gp.posterior import posterior_block
    from scasml_gp_torch.gp.semigroup import mixture_features
    from scasml_gp_torch.harness import runner
    from scasml_gp_torch.harness.metrics import mc_reference_solution
    from scasml_gp_torch.measure import event_ms

    def config_for(equation):
        return port.RunConfig(
            equation=equation, dim=EXTRA_D, num_domain=N_DOM,
            num_boundary=N_BDY, test_domain=N_TEST_DOM,
            test_boundary=N_TEST_BDY, seed=1234, harness="SimpleUniform",
            save_path=EXTRA_DIR,
            picard=port.PicardConfig(variant="full_history", n=2, rho=2, M=3),
        )

    def test_points(eq):  # the harness's test set (seed + 1)
        gen = torch.Generator(device=dev).manual_seed(1235)
        return torch.cat(eq.generate_test_data(N_TEST_DOM, N_TEST_BDY, gen,
                                               device=dev))

    def feature_ms(tag, fn, rows, eq):
        x = eq.geometry().sample_domain(
            torch.Generator(device=dev).manual_seed(8), rows, device=dev)
        for need in (False, True):
            ms = event_ms(lambda: fn(x, need))
            print(f"[extra] {tag} feature block, want_grad=want_ops={need:d}, "
                  f"{rows} rows: {ms:.4f} ms per call (CUDA events; {smi})",
                  flush=True)

    # 6a. SineNonlinear, flagless: tuned, every posterior through the kernel
    config = config_for("SineNonlinear")
    check(runner.resolve_tune(None, 0.0, 1.0, False, config.equation),
          "a flagless SineNonlinear run does not tune")
    torch.cuda.synchronize()
    fp.reset_launches()
    t0 = time.perf_counter()
    config, tuned = runner.tuned_config(config, dev)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    tune_launches = dict(fp.launches_by_flags)
    print(f"[extra] Sine d={EXTRA_D}: winner ridge_scale="
          f"{config.gp.ridge_scale} gamma_scale={config.gp.gamma_scale} score "
          f"{tuned.score:.6g}; tune launches {by_flags_str(tune_launches)}",
          flush=True)
    result, run_launches, eq, gp, sca = extra_run(config, dev)
    rel = report_run(f"Sine d={EXTRA_D}", smi, result, run_launches, sca, tune_s)
    check(rel["GP"] < 0.08, f"Sine GP rel-L2 {rel['GP']} not below 0.08")
    check(rel["SCaSML"] < rel["GP"],
          f"Sine SCaSML rel-L2 {rel['SCaSML']} not below GP {rel['GP']}")
    check(rel["MLP"] < 0.25, f"Sine MLP rel-L2 {rel['MLP']} not below 0.25")
    for flags in MAIN_SPECS:
        check(tune_launches.get(flags, 0) > 0 and run_launches.get(flags, 0) > 0,
              f"Sine: the kernel {flags} was not launched in the tune and run")
    st = gp.state
    fused = st.fused_inputs()
    gen_x = torch.Generator(device=dev).manual_seed(6)
    records = {}
    for flags, n in EXTRA_ROWS.items():
        x = eq.geometry().sample_domain(gen_x, n, device=dev)
        err = compare_kernel(x, fused, st.x_dom, st.x_bdy, st.right_vector,
                             st.gamma, EXTRA_D, flags,
                             f"tuned Sine GP d={EXTRA_D}, n={n}")
        records[flags] = kernel_record(x, fused, flags, lambda: posterior_block(
            x, st.x_dom, st.x_bdy, st.right_vector, st.gamma, EXTRA_D, *flags), err)
        records[flags]["launches"] = {"tune": tune_launches.get(flags, 0),
                                      "run": run_launches.get(flags, 0)}
        print(f"[extra] Sine d={EXTRA_D} kernel (want_grad={flags[0]:d}, "
              f"want_ops={flags[1]:d}) n={n}, F={EXTRA_D + 1}: "
              f"{describe(records[flags])} ({smi})", flush=True)

    # 6b. HJB, the CLI default: the exact Bernstein-mixture surrogate
    config = config_for("HJB")
    check(not runner.resolve_tune(None, 0.0, 1.0, False, config.equation),
          "a flagless HJB run tunes")
    result, launches, eq, gp, sca = extra_run(config, dev)
    rel = report_run(f"HJB d={EXTRA_D} mixture", smi, result, launches, sca)
    check(gp.terminal_backend == "mixture", "HJB's default is not the mixture")
    check(sum(launches.values()) == 0,
          f"HJB mixture path launched the fused kernel: {launches}")
    check(rel["GP"] < 0.002, f"HJB GP rel-L2 {rel['GP']} not below 0.002")
    check(abs(rel["SCaSML"] - rel["GP"]) < 0.002,
          f"HJB SCaSML rel-L2 {rel['SCaSML']} not within 0.002 of GP")
    check(rel["MLP"] < 0.4, f"HJB MLP rel-L2 {rel['MLP']} not below 0.4")
    x_test = test_points(eq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact = eq.exact_solution(x_test)
    torch.cuda.synchronize()
    print(f"[extra] HJB d={EXTRA_D} Cole-Hopf MC oracle (32768 samples) on "
          f"{x_test.shape[0]} points: {time.perf_counter() - t0:.4f} s ({smi})",
          flush=True)
    feature_ms(f"HJB d={EXTRA_D} mixture_features", lambda x, need:
               mixture_features(x, gp.state.right_vector, gp.state.sol, gp.sig2,
                                eq.T, EXTRA_D, need, need), 10800, eq)

    # 6c. HJB, the coarse scattered-rbf surrogate: the guard repairs it
    result, launches, eq, gp, sca = extra_run(
        config, dev,
        make_gp=lambda e: GPHJBColeHopf(e, config.gp, device=dev,
                                        terminal_backend="rbf"))
    rel = report_run(f"HJB d={EXTRA_D} coarse rbf", smi, result, launches, sca)
    check(sum(launches.values()) == 0,
          f"HJB rbf path launched the fused kernel: {launches}")
    check(0.08 <= rel["GP"] <= 0.18, f"HJB rbf GP rel-L2 {rel['GP']} "
          "outside [0.08, 0.18]")
    check(rel["SCaSML"] < 0.75 * rel["GP"],
          f"HJB rbf SCaSML rel-L2 {rel['SCaSML']} not below 0.75 x GP")
    check(sca.last_lambda is not None and sca.last_lambda >= 0.5,
          f"HJB rbf: the ladder accepted no candidate ({sca.last_lambda})")
    st = gp.state
    alpha64, mbar64, _ = terminal_fit(sq_dists(st.x_bdy[:, :-1]).double(),
                                      st.sol.double(), gp.width, gp.fit_nugget)
    st64 = port.GPState(
        x_dom=st.x_dom, x_bdy=st.x_bdy, right_vector=alpha64.float(), sol=st.sol,
        gamma=torch.stack([st.gamma[0], st.gamma[1], mbar64.float()]),
        loss_history=st.loss_history)
    e32 = rel_l2(gp.predict(x_test), exact)
    e64 = rel_l2(gp.posterior_u(st64, x_test).u, exact)
    print(f"[extra] HJB rbf terminal fit (m={st.x_bdy.shape[0]}): GP rel-L2 "
          f"{e32:.6f} with the float32 Cholesky, {e64:.6f} with a float64 "
          f"factorization of the same points; fit rms "
          f"{float(st.loss_history[0]):.3g}", flush=True)
    check(abs(e32 - e64) < 0.1 * e64, f"HJB rbf: the float32 fit's rel-L2 "
          f"{e32} is not within 10% of the float64 fit's {e64}")
    feature_ms(f"HJB d={EXTRA_D} rbf _v_block", lambda x, need:
               gp._v_posterior(st, x, need, need), 10800, eq)

    # 6d. AllenCahn: the mixture surrogate against the deep-MC oracle
    config = config_for("AllenCahn")
    result, launches, eq, gp, sca = extra_run(config, dev)
    rel = report_run(f"AllenCahn d={EXTRA_D}", smi, result, launches, sca)
    with open(os.path.join(runner.run_dir(config), "SimpleUniform",
                           "metrics.json")) as fh:
        oc = json.load(fh)["oracle_consistency"]
    print(f"[extra] AllenCahn d={EXTRA_D}: MC oracle half-run disagreement "
          f"{oc['half_run_rel_disagreement']:.6f}", flush=True)
    check(sum(launches.values()) == 0,
          f"AllenCahn path launched the fused kernel: {launches}")
    check(rel["GP"] < 0.01, f"AllenCahn GP rel-L2 {rel['GP']} not below 0.01")
    check(rel["SCaSML"] < 0.01,
          f"AllenCahn SCaSML rel-L2 {rel['SCaSML']} not below 0.01")
    check(rel["MLP"] < 0.05, f"AllenCahn MLP rel-L2 {rel['MLP']} not below 0.05")
    x_test = test_points(eq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mc_reference_solution(eq, x_test, seed=123)
    torch.cuda.synchronize()
    print(f"[extra] AllenCahn d={EXTRA_D} MC oracle (one of the two runs, "
          f"n=3, M=8) on {x_test.shape[0]} points: "
          f"{time.perf_counter() - t0:.4f} s ({smi})", flush=True)
    feature_ms(f"AllenCahn d={EXTRA_D} mixture_features", lambda x, need:
               mixture_features(x, gp.state.right_vector, gp.state.sol, gp.sig2,
                                eq.T, EXTRA_D, need, need), 10800, eq)
    return records


FITML_DIR = "results/smoke_fitml"
FIT_ROUNDS, FIT_RESTARTS, FIT_STEPS = 3, 6, 30  # fit_gp_marginal_likelihood's
FIT_ROWS = 1 + 1 + FIT_RESTARTS                 # base, the grid seed, restarts
GRID_CANDIDATES = 4
# Posterior calls pinned on the CPU by tests/test_torch_marginal.py: the
# judge scores each grid candidate and each row of the fit's table with
# JUDGE_VAL_SETS rollouts; the fit's rounds make none.
EXPECTED_GRID_LAUNCHES = {k: v * GRID_CANDIDATES * JUDGE_VAL_SETS
                          for k, v in JUDGE_LAUNCHES.items()}
EXPECTED_FIT_LAUNCHES = {k: v * FIT_ROWS * JUDGE_VAL_SETS
                         for k, v in JUDGE_LAUNCHES.items()}


def fit_ml_phase(dev, smi):
    """Phase 7: --fit-ml (runner.fitted_config, then runner.run) at d=20;
    returns the launches of its parts by specialisation."""
    import numpy as np
    import torch

    import scasml_gp_torch as port
    from scasml_gp_torch.gp import fused_posterior as fp
    from scasml_gp_torch.gp import marginal
    from scasml_gp_torch.harness import runner

    config = port.RunConfig(
        dim=D, num_domain=N_DOM, num_boundary=N_BDY, test_domain=N_TEST_DOM,
        test_boundary=N_TEST_BDY, seed=1234, harness="SimpleUniform",
        save_path=FITML_DIR,
        picard=port.PicardConfig(variant="full_history", n=2, rho=2, M=3),
    )
    # The fit's parts, timed (host clock, synchronized) and their launches
    # counted by wrapping the functions fitted_config reaches.
    parts = {}

    def timed(part, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            before = dict(fp.launches_by_flags)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            p = parts.setdefault(part, {"s": 0.0, "calls": 0, "launches": {}})
            p["s"] += time.perf_counter() - t0
            p["calls"] += 1
            for k, v in fp.launches_by_flags.items():
                p["launches"][k] = p["launches"].get(k, 0) + v - before.get(k, 0)
            return out
        return wrapper

    def judge_timed(make):
        return lambda *a, **kw: timed("judge", make(*a, **kw))

    wrapped = [(runner, "tune_gp", timed, "grid"),
               (runner, "fit_gp_marginal_likelihood", timed, "fit"),
               (marginal, "_descend", timed, "adam"),
               (marginal, "scasml_judge", None, None)]
    originals = [getattr(owner, name) for owner, name, _, _ in wrapped]
    for owner, name, wrap, part in wrapped:
        fn = getattr(owner, name)
        setattr(owner, name, wrap(part, fn) if wrap else judge_timed(fn))
    torch.cuda.synchronize()
    fp.reset_launches()
    try:
        config, fit = runner.fitted_config(config, dev)
    finally:
        for (owner, name, _, _), fn in zip(wrapped, originals):
            setattr(owner, name, fn)
    torch.cuda.synchronize()
    path_launches = dict(fp.launches_by_flags)
    grid_s, fit_s = parts["grid"]["s"], parts["fit"]["s"]
    judge_s, adam_s = parts["judge"]["s"], parts["adam"]["s"]
    rounds_s = fit_s - judge_s
    print(f"[fit-ml] {smi}; grid ({GRID_CANDIDATES} candidates) {grid_s:.3f} s; "
          f"fit {fit_s:.3f} s = judge of {parts['judge']['calls']} candidates "
          f"{judge_s:.3f} s + {FIT_ROUNDS} outer rounds {rounds_s:.3f} s, one round "
          f"{rounds_s / FIT_ROUNDS:.3f} s = Adam {adam_s / FIT_ROUNDS:.3f} s "
          f"({FIT_RESTARTS} x {FIT_STEPS} steps) + Newton trains and final NLML "
          f"{(rounds_s - adam_s) / FIT_ROUNDS:.3f} s (host clock, synchronized)",
          flush=True)
    for i, row in enumerate(fit.history):
        print(f"[fit-ml] NLML after round {i + 1}: "
              + ", ".join(f"{v:.6g}" for v in row), flush=True)
    for cfg, nlml, score in fit.table:
        print(f"[fit-ml] candidate ridge_scale={cfg.ridge_scale:.6g} "
              f"gamma_scale={cfg.gamma_scale:.6g} time_scale={cfg.time_scale:.6g} "
              f"nugget={cfg.nugget:g}: NLML {nlml:.6g}, score {score:.6g}", flush=True)
    shipped = [score for cfg, _, score in fit.table if cfg == fit.config][0]
    print(f"[fit-ml] shipped: {fit.config} (score {shipped:.6g}; grid seed "
          f"{fit.table[1][2]:.6g})", flush=True)
    check(np.isfinite(fit.history).all(), "the fit's NLML history is not finite")
    check(fit.history.shape == (FIT_ROUNDS, FIT_RESTARTS),
          f"history shape {fit.history.shape}")
    check(len(fit.table) == FIT_ROWS, f"{len(fit.table)} table rows, expected {FIT_ROWS}")
    check(all(math.isfinite(score) for _, _, score in fit.table), "a score is not finite")
    check(shipped <= fit.table[1][2], "the shipped config scores worse than the grid seed")

    fp.reset_launches()
    runner.run(config, device=dev, make_plots=False)
    torch.cuda.synchronize()
    run_launches = dict(fp.launches_by_flags)
    with open(os.path.join(runner.run_dir(config), "SimpleUniform", "metrics.json")) as fh:
        written = json.load(fh)
    check(key_tree(written) == METRICS_KEYS, "fit-ml metrics.json keys")
    check(all(isinstance(v, (int, float)) and math.isfinite(v)
              for v in leaves(written)), "fit-ml metrics.json holds a non-finite value")
    rel = {k: written["metrics"][k]["rel_L2"] for k in SOLVERS}
    print(f"[fit-ml] {smi}; rel-L2: GP {rel['GP']:.6f}, MLP {rel['MLP']:.6f}, "
          f"SCaSML {rel['SCaSML']:.6f}", flush=True)
    launches = {"grid": parts["grid"]["launches"], "fit": parts["fit"]["launches"],
                "run": run_launches}
    print("[fit-ml] kernel launches: " + ", ".join(
        f"{k} {by_flags_str(v)}" for k, v in launches.items()), flush=True)
    check(launches["grid"] == EXPECTED_GRID_LAUNCHES,
          f"grid launches {launches['grid']} != {EXPECTED_GRID_LAUNCHES}")
    check(launches["fit"] == EXPECTED_FIT_LAUNCHES,
          f"fit launches {launches['fit']} != {EXPECTED_FIT_LAUNCHES}")
    check(path_launches == {k: EXPECTED_GRID_LAUNCHES[k] + EXPECTED_FIT_LAUNCHES[k]
                            for k in JUDGE_LAUNCHES},
          f"fitted_config launches {path_launches}")
    check(run_launches == EXPECTED_RUN_LAUNCHES,
          f"run launches {run_launches} != {EXPECTED_RUN_LAUNCHES}")
    check(rel["GP"] < 0.06, f"fitted GP rel-L2 {rel['GP']} not below 0.06")
    check(rel["SCaSML"] < rel["GP"],
          f"SCaSML rel-L2 {rel['SCaSML']} not below GP {rel['GP']}")
    return {flags: {k: v.get(flags, 0) for k, v in launches.items()}
            for flags in MAIN_SPECS}


SWEEPS_DIR = "results/smoke_sweeps"
SWEEPS = ("ConvergenceRate", "InferenceScaling", "SimpleScaling", "ComputingBudget")
# The JAX package's committed metrics.json of each sweep at this width
JAX_SWEEP = "reports/campaign/GradDependentNonlinear/20d/full_history/{}/metrics.json"
CR_SMALLEST = (100, 20)  # ConvergenceRate's first training size


def cumulative_counter(schedule):
    """ScaSMLFullHistory's evaluation_counter after each (n, M) solve."""
    from scasml_gp_torch.picard.schedule import count_evaluations_full_history

    out, total = [], 0
    for n, M in schedule:
        total += count_evaluations_full_history(n, M, scasml_variant=True,
                                                count_fg=True)
        out.append(total)
    return out


def sweeps_phase(dev, smi, tuned):
    """Phase 8: the four sweep harnesses through runner.run with the tuned
    config of phase 5; returns their launches and the kernel records at
    the new shapes."""
    import dataclasses

    import torch

    from scasml_gp_torch.gp import fused_posterior as fp
    from scasml_gp_torch.gp.posterior import posterior_block
    from scasml_gp_torch.harness import runner

    M = tuned.picard.M
    # (flags, rows, training rows) of every kernel call, by harness
    shapes = {h: {} for h in SWEEPS}
    launch = fp.fused_posterior
    current = [None]

    def recording(x, fused, want_grad=False, want_ops=False):
        key = ((bool(want_grad), bool(want_ops)), x.shape[0], fused.y.shape[0])
        seen = shapes[current[0]]
        seen[key] = seen.get(key, 0) + 1
        return launch(x, fused, want_grad, want_ops)

    results, launches = {}, {}
    fp.fused_posterior = recording
    try:
        for h in SWEEPS:
            config = dataclasses.replace(tuned, harness=h, save_path=SWEEPS_DIR)
            current[0] = h
            torch.cuda.synchronize()
            fp.reset_launches()
            t0 = time.perf_counter()
            runner.run(config, device=dev, make_plots=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[h] = dict(fp.launches_by_flags)
            with open(os.path.join(runner.run_dir(config), h, "metrics.json")) as fh:
                results[h] = json.load(fh)
            print(f"[sweeps] {h}: {wall:.3f} s (host clock, synchronized; {smi}); "
                  f"kernel launches {by_flags_str(launches[h])}", flush=True)
    finally:
        fp.fused_posterior = launch

    for h in SWEEPS:
        r = results[h]
        with open(JAX_SWEEP.format(h)) as fh:
            want = json.load(fh)
        check(key_tree(r) == key_tree(want),
              f"{h} metrics.json keys {key_tree(r)} != the JAX package's {key_tree(want)}")
        check(all(isinstance(v, (int, float)) and math.isfinite(v) for v in leaves(r)),
              f"{h} metrics.json holds a non-finite value")
        check(sum(launches[h].values()) > 0, f"{h} launched no kernel")
    for flags in MAIN_SPECS:
        check(sum(launches[h].get(flags, 0) for h in SWEEPS) > 0,
              f"the sweeps never launched the kernel {flags}")

    cr = results["ConvergenceRate"]
    for n, g, s in zip(cr["train_sizes"], cr["rel_L2"]["GP"], cr["rel_L2"]["SCaSML"]):
        print(f"[sweeps] ConvergenceRate N={n}: GP {g:.6f}, SCaSML {s:.6f}", flush=True)
    print(f"[sweeps] ConvergenceRate slopes: GP {cr['slopes']['GP']:.4f}, "
          f"SCaSML {cr['slopes']['SCaSML']:.4f}", flush=True)
    inf = results["InferenceScaling"]
    for i, rho in enumerate(inf["rho"]):
        print(f"[sweeps] InferenceScaling rho={rho}: evals "
              f"{inf['evaluation_counter'][i]}, GP {inf['rel_L2']['GP'][i]:.6f}, "
              f"MLP {inf['rel_L2']['MLP'][i]:.6f}, SCaSML "
              f"{inf['rel_L2']['SCaSML'][i]:.6f}, improvement "
              f"{inf['improvement_pct'][i]:.2f}%", flush=True)
    ss = results["SimpleScaling"]
    for i, base in enumerate(ss["sample_base"]):
        print(f"[sweeps] SimpleScaling M={base}: evals {ss['evaluation_counter'][i]}, "
              f"GP {ss['rel_L2']['GP'][i]:.6f}, MLP {ss['rel_L2']['MLP'][i]:.6f}, "
              f"SCaSML {ss['rel_L2']['SCaSML'][i]:.6f}, improvement "
              f"{ss['improvement_pct'][i]:.2f}%", flush=True)
    cb = results["ComputingBudget"]
    for i, level in enumerate(cb["budget_levels"]):
        print(f"[sweeps] ComputingBudget level {level}: " + ", ".join(
            f"{k} {cb['rel_L2'][k][i]:.6f} ({cb['times'][k][i]:.3f} s)"
            for k in SOLVERS), flush=True)

    want_inf = cumulative_counter([(rho, M) for rho in inf["rho"]])
    want_ss = cumulative_counter([(1, base) for base in ss["sample_base"]])
    check(inf["evaluation_counter"] == want_inf,
          f"InferenceScaling counters {inf['evaluation_counter']} != {want_inf}")
    check(ss["evaluation_counter"] == want_ss,
          f"SimpleScaling counters {ss['evaluation_counter']} != {want_ss}")
    for h in ("ConvergenceRate", "SimpleScaling"):
        rows = results[h]["rel_L2"]
        check(all(s < g for s, g in zip(rows["SCaSML"], rows["GP"])),
              f"{h}: SCaSML not below GP at every row ({rows})")
    check(all(v > 0 for v in inf["improvement_pct"]),
          f"InferenceScaling improvement {inf['improvement_pct']} not above 0")
    # ComputingBudget gives ScaSML's surrogate max(1, 5 b // 2) Newton steps
    # against the GP's 5 b.  Whether SCaSML beats the GP at a level depends
    # on whether that surrogate has converged, which varies with the draw in
    # both packages (PERF.md, section 6): SCaSML is held below the GP at the
    # largest budget and below MLP at every one, and the tuned kernel's
    # Newton losses on this draw are printed below.
    rows = cb["rel_L2"]
    check(rows["SCaSML"][-1] < rows["GP"][-1],
          f"ComputingBudget: SCaSML not below GP at the largest budget ({rows})")
    check(all(s < m for s, m in zip(rows["SCaSML"], rows["MLP"])),
          f"ComputingBudget: SCaSML not below MLP at every level ({rows})")

    # The kernel against its plain version at the sweeps' new shapes: the
    # smallest ConvergenceRate GP at the largest call of each specialisation,
    # and SimpleScaling's M = 15 calls against the run's GP.
    eq, gp_small, _, _ = runner.build_solvers(tuned, dev)
    gen = torch.Generator(device=dev).manual_seed(tuned.seed + 100)
    gp_small.GPsolver(*eq.generate_data(*CR_SMALLEST, gen, device=dev), GN_steps=20)
    _, gp_full, _, _ = runner.build_solvers(tuned, dev)
    gen = torch.Generator(device=dev).manual_seed(tuned.seed)
    gp_full.GPsolver(*eq.generate_data(N_DOM, N_BDY, gen, device=dev))
    loss = gp_full.loss_history.tolist()
    print(f"[sweeps] tuned kernel's Newton loss by step on the harnesses' "
          f"{N_DOM} + {N_BDY} points: " + " ".join(f"{v:.4g}" for v in loss)
          + f" (within 1% of the last from step "
          f"{min(i for i, v in enumerate(loss) if v <= 1.01 * loss[-1])})", flush=True)
    cases = {
        f"convergence_rate_{CR_SMALLEST[0]}+{CR_SMALLEST[1]}":
            ("ConvergenceRate", gp_small, tuple(MAIN_SPECS)),
        f"simple_scaling_M{ss['sample_base'][-1]}":
            ("SimpleScaling", gp_full, ((False, False), (False, True))),
    }
    gen_x = torch.Generator(device=dev).manual_seed(9)
    records = {flags: {} for flags in MAIN_SPECS}
    for tag, (h, gp, specs) in cases.items():
        st = gp.state
        fused = st.fused_inputs()
        m = fused.y.shape[0]
        for flags in specs:
            n = max(rows for (f, rows, mm) in shapes[h] if f == flags and mm == m)
            x = eq.geometry().sample_domain(gen_x, n, device=dev)
            err = compare_kernel(x, fused, st.x_dom, st.x_bdy, st.right_vector,
                                 st.gamma, D, flags, f"{tag}, n={n}", repeat=True)
            rec = kernel_record(x, fused, flags, lambda: posterior_block(
                x, st.x_dom, st.x_bdy, st.right_vector, st.gamma, D, *flags), err)
            rec["training_rows"] = m
            records[flags][tag] = rec
            print(f"[sweeps] kernel {MAIN_SPECS[flags][0]} (want_grad={flags[0]:d}, "
                  f"want_ops={flags[1]:d}) {tag}: n={n} against {m} training rows: "
                  f"{describe(rec)} ({smi})", flush=True)
    return {flags: {"launches": {h: launches[h].get(flags, 0) for h in SWEEPS},
                    **records[flags]} for flags in MAIN_SPECS}

LARGE_DIR = "results/smoke_large_n"
LARGE_N, LARGE_NB = 8192, 512      # reports/campaign_largeN: phi = 33 280
BOTH_N, BOTH_NB = 2000, 200        # phi = 8 200: the dense trainer takes it too
LARGE_CHECK_ROWS = 1200


def large_n_phase(dev, smi):
    """Phase 9: (a) the dense and the distributed trainer on one problem
    both take; (b) the users' large-N runner path, flagless, where 'auto'
    sends the tune and the train to the distributed trainer.  Returns the
    kernel records at the path's shapes."""
    import statistics

    import torch

    import scasml_gp_torch as port
    from scasml_gp_torch.gp import distributed
    from scasml_gp_torch.gp import fused_posterior as fp
    from scasml_gp_torch.gp.posterior import posterior_block
    from scasml_gp_torch.harness import runner
    from scasml_gp_torch.measure import HBM_RATE

    # 9a. dense against distributed at phi = 8 200, the untuned kernel
    eq = port.GradDependentNonlinear(n_input=D + 1)
    x_dom, x_bdy = eq.generate_data(BOTH_N, BOTH_NB,
                                    torch.Generator(device=dev).manual_seed(1234), device=dev)
    x_eval = eq.geometry().sample_domain(torch.Generator(device=dev).manual_seed(3),
                                         LARGE_CHECK_ROWS, device=dev)
    gps, secs = {}, {}
    for backend in ("dense", "distributed"):
        gps[backend] = port.GPGradDependentNonlinear(
            eq, port.GPConfig(train_backend=backend), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if backend == "dense":
            gps[backend].GPsolver(x_dom, x_bdy)
        else:
            cfg = gps[backend].config
            out = distributed.distributed_gpsolver(
                gps[backend], x_dom, x_bdy, gn_steps=cfg.dist_gn_steps,
                cg_tol=cfg.dist_cg_tol, cg_maxiter=cfg.dist_cg_maxiter)
        torch.cuda.synchronize()
        secs[backend] = time.perf_counter() - t0
    preds = {k: gp.predict(x_eval) for k, gp in gps.items()}
    rel = rel_l2(preds["distributed"], preds["dense"])
    resid = float(out.final_residual)
    print(f"[large-n] {smi}; d={D}, N={BOTH_N} + {BOTH_NB} (phi {4 * BOTH_N + BOTH_NB}), "
          f"untuned: dense train {secs['dense']:.3f} s (20 Newton steps), distributed "
          f"{secs['distributed']:.3f} s ({out.loss_history.shape[0]} Gauss-Newton steps, "
          f"CG iterations {out.cg_iterations.tolist()}), final_residual {resid:.3g}; "
          f"predictions at {LARGE_CHECK_ROWS} points differ by rel {rel:.3g}", flush=True)
    print("[large-n] loss dense " + " ".join(
        f"{v:.6g}" for v in gps["dense"].state.loss_history.tolist()), flush=True)
    print("[large-n] loss distributed " + " ".join(
        f"{v:.6g}" for v in gps["distributed"].state.loss_history.tolist()), flush=True)
    check(math.isfinite(resid), f"distributed final_residual {resid} not finite")
    check(rel < 2e-2, f"dense and distributed predictions differ by rel {rel}")
    del gps, preds

    # 9b. runner --num-domain 8192 --num-boundary 512, flagless
    config = port.RunConfig(
        dim=D, num_domain=LARGE_N, num_boundary=LARGE_NB, test_domain=N_TEST_DOM,
        test_boundary=N_TEST_BDY, seed=1234, harness="SimpleUniform",
        save_path=LARGE_DIR,
        picard=port.PicardConfig(variant="full_history", n=2, rho=2, M=3))
    # Every Gram assembly and every train of the distributed trainer timed
    # (host clock, synchronized) and kept with its inputs and output; the
    # dense trainer only counted, as it must not run.
    trains, grams, dense = [], [], []

    def timed(record, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            record(time.perf_counter() - t0, args, out)
            return out
        return call

    gram, make, dense_train = (distributed.gram_matrix,
                               distributed.make_distributed_train, port.GP._train)
    distributed.gram_matrix = timed(lambda t, a, o: grams.append(t), gram)
    distributed.make_distributed_train = lambda *a, **kw: timed(
        lambda t, args, out: trains.append((t, args, out)), make(*a, **kw))
    port.GP._train = lambda *a, **kw: dense.append(1) or dense_train(*a, **kw)
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        fp.reset_launches()
        t0 = time.perf_counter()
        config, tuned = runner.tuned_config(config, dev)
        torch.cuda.synchronize()
        tune_s = time.perf_counter() - t0
        tune_launches = dict(fp.launches_by_flags)
        tune_trains = len(trains)
        tune_peak = torch.cuda.max_memory_allocated(dev) / 2**30
        torch.cuda.reset_peak_memory_stats(dev)
        fp.reset_launches()
        runner.run(config, device=dev, make_plots=False)
        torch.cuda.synchronize()
        run_launches = dict(fp.launches_by_flags)
        run_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    finally:
        distributed.make_distributed_train = make
        distributed.gram_matrix = gram
        port.GP._train = dense_train
    with open(os.path.join(runner.run_dir(config), "SimpleUniform", "metrics.json")) as fh:
        written = json.load(fh)
    rel = {k: written["metrics"][k]["rel_L2"] for k in SOLVERS}
    train_s = [t for t, _, _ in trains]
    iters = [out.cg_iterations.tolist() for _, _, out in trains]
    # GEMVs with K per train: each CG's iterations as run (pcg runs up to
    # CHECK_EVERY - 1 frozen ones past its stop), its r0, each step's b*
    # and the final residual.
    every, cap = distributed.CHECK_EVERY, config.gp.dist_cg_maxiter
    matvecs = sum(min(cap, -(-k // every) * every) + 2 for it in iters for k in it)
    gemv_bound_ms = 1e3 * 4 * (4 * LARGE_N + LARGE_NB) ** 2 / HBM_RATE
    print(f"[large-n] {smi}; runner --dim {D} --variant full_history --num-domain "
          f"{LARGE_N} --num-boundary {LARGE_NB} (phi {4 * LARGE_N + LARGE_NB}), "
          f"flagless: tune {len(tuned.table)} candidates in {tune_s:.3f} s; winner "
          f"ridge_scale={config.gp.ridge_scale} gamma_scale={config.gp.gamma_scale} "
          f"score {tuned.score:.6g}", flush=True)
    print(f"[large-n] Gram assembly {statistics.median(grams):.3f} s median of "
          f"{len(grams)}; train per candidate {statistics.median(train_s[:tune_trains]):.3f} s "
          f"median ({min(train_s[:tune_trains]):.3f}-{max(train_s[:tune_trains]):.3f}); "
          f"the run's train {train_s[-1]:.3f} s; {matvecs} GEMVs with K in the "
          f"{len(trains)} trains, {1e3 * (sum(train_s) - sum(grams)) / matvecs:.3f} ms "
          f"each with the CG's vector work, Gram assembly excluded (bound: K's bytes "
          f"over 3.35 TB/s, {gemv_bound_ms:.3f} ms); host clock, synchronized; peak "
          f"device memory tune {tune_peak:.2f} GiB, run {run_peak:.2f} GiB", flush=True)
    for (cfg, score), it, (_, _, out), t in zip(tuned.table, iters, trains, train_s):
        print(f"[large-n] candidate ridge_scale={cfg.ridge_scale:g} gamma_scale="
              f"{cfg.gamma_scale:g}: score {score:.6g}, train {t:.3f} s, CG iterations "
              f"{it}, final_residual {float(out.final_residual):.3g}", flush=True)
    out = trains[-1][2]
    print(f"[large-n] the run's train: CG iterations {iters[-1]}, final_residual "
          f"{float(out.final_residual):.3g}, loss " + " ".join(
              f"{v:.6g}" for v in out.loss_history.tolist()), flush=True)
    print(f"[large-n] kernel launches: tune {by_flags_str(tune_launches)}, run "
          f"{by_flags_str(run_launches)}", flush=True)
    print(f"[large-n] rel-L2: GP {rel['GP']:.6f}, MLP {rel['MLP']:.6f}, SCaSML "
          f"{rel['SCaSML']:.6f} (JAX package, 10 reps: GP 0.0181, SCaSML 0.0115)", flush=True)
    check(not dense, f"the large-N path trained {len(dense)} times through the dense trainer")
    check(tune_trains == TUNE_CANDIDATES and len(trains) == TUNE_CANDIDATES + 1,
          f"{tune_trains} tune and {len(trains) - tune_trains} run trains went through "
          f"the distributed trainer, expected {TUNE_CANDIDATES} and 1")
    check(all(math.isfinite(float(o.final_residual)) for _, _, o in trains),
          "a final_residual is not finite")
    check(key_tree(written) == METRICS_KEYS, "large-N metrics.json keys")
    for flags in MAIN_SPECS:
        check(tune_launches.get(flags, 0) > 0 and run_launches.get(flags, 0) > 0,
              f"large-N: the kernel {flags} was not launched in the tune and run")
    check(rel["GP"] < 0.03, f"large-N GP rel-L2 {rel['GP']} not below 0.03")
    check(rel["SCaSML"] < rel["GP"],
          f"large-N SCaSML rel-L2 {rel['SCaSML']} not below GP {rel['GP']}")

    # The kernel against its plain version with the run's weights at the
    # run's shapes, against 8 704 training rows.
    (x_dom, x_bdy, _, _, gamma, _), w = trains[-1][1], trains[-1][2].right_vector
    st = port.GPState(x_dom=x_dom, x_bdy=x_bdy, right_vector=w, sol=trains[-1][2].sol,
                      gamma=gamma, loss_history=trains[-1][2].loss_history)
    fused = st.fused_inputs()
    gen_x = torch.Generator(device=dev).manual_seed(10)
    records = {}
    for flags, (caller, n) in FH_SPECS.items():
        x = eq.geometry().sample_domain(gen_x, n, device=dev)
        errs = compare_kernel(x, fused, x_dom, x_bdy, w, gamma, D, flags,
                              f"large-N GP, n={n}", repeat=True)
        rec = kernel_record(x, fused, flags, lambda: posterior_block(
            x, x_dom, x_bdy, w, gamma, D, *flags), errs)
        rec["training_rows"] = fused.y.shape[0]
        rec["launches"] = {"tune": tune_launches.get(flags, 0),
                           "run": run_launches.get(flags, 0)}
        records[flags] = rec
        print(f"[large-n] kernel {caller} (want_grad={flags[0]:d}, want_ops={flags[1]:d}) "
              f"n={n} against {rec['training_rows']} training rows: {describe(rec)} ({smi})",
              flush=True)
    return records


SERVE_DIR = "results/smoke_serve"
SERVE_BUCKETS = (256, 1024, 4096)
SERVE_ROWS = (33, 1000, 5000)      # 5000 is chunked: 4096 + 904 in the 1024 bucket
SERVE_ATOL = 2e-4
SERVE_REPEATS = 20


def post(url, x):
    import urllib.request

    import numpy as np

    req = urllib.request.Request(url, data=json.dumps({"points": x.tolist()}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return np.asarray(json.load(r)["values"], np.float32)


def serve_phase(dev, smi, gp):
    """Phase 10: phase 5's tuned surrogate saved, loaded and served in
    buckets through Python and HTTP."""
    import statistics

    import numpy as np
    import torch

    from scasml_gp_torch.gp import fused_posterior as fp
    from scasml_gp_torch.picard.scasml import ScaSMLFullHistory
    from scasml_gp_torch.serve import (SurrogateServer, load_surrogate, save_surrogate,
                                       serve_http)

    save_surrogate(SERVE_DIR, gp)
    loaded = load_surrogate(SERVE_DIR)
    check(loaded.device.type == "cuda", f"load_surrogate put the surrogate on {loaded.device}")
    server = SurrogateServer(loaded, ScaSMLFullHistory(loaded.equation, loaded),
                             buckets=SERVE_BUCKETS, n=2, rho=None, M=3)
    endpoints = ("predict", "gradient", "solve")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server.warmup(endpoints)
    print(f"[serve] {smi}; warmup of {len(endpoints)} endpoints x buckets "
          f"{SERVE_BUCKETS}: {time.perf_counter() - t0:.3f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(12)
    xs = {n: gp.equation.geometry().sample_domain(gen, n, device=dev) for n in SERVE_ROWS}
    httpd = serve_http(server, port=0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    requests = warm = server.requests
    torch.cuda.synchronize()
    fp.reset_launches()
    try:
        for n, x in xs.items():
            direct = {"predict": gp.predict(x).cpu().numpy(),
                      "gradient": gp.compute_gradient(x).cpu().numpy()}
            x_np = x.cpu().numpy()
            for ep in endpoints:
                py = getattr(server, ep)(x_np)
                http = post(f"{base}/{ep}", x_np)
                requests += 2
                check(py.shape == http.shape == (n, 1 if ep != "gradient" else D + 1),
                      f"/{ep} of {n} rows: shapes {py.shape}, {http.shape}")
                check(np.array_equal(py, http), f"/{ep} of {n} rows: HTTP != Python")
                if ep == "solve":
                    again = post(f"{base}/solve", x_np)
                    requests += 1
                    check(np.array_equal(again, http),
                          f"two identical /solve requests of {n} rows differ")
                    check(np.isfinite(py).all(), f"/solve of {n} rows not finite")
                    err = float(np.abs(py - direct["predict"]).max())
                    print(f"[serve] /solve {n} rows: repeat bitwise equal; largest "
                          f"correction {err:.4g}", flush=True)
                else:
                    err = float(np.abs(py - direct[ep]).max())
                    print(f"[serve] /{ep} {n} rows: max abs err against the direct "
                          f"call {err:.3g}", flush=True)
                    check(err < SERVE_ATOL, f"/{ep} of {n} rows off the direct call by {err}")
        torch.cuda.synchronize()
        launches = dict(fp.launches_by_flags)
        st = server.stats()
        check(st["requests"] == requests and st["rows"] >= sum(SERVE_ROWS),
              f"stats {st} (expected {requests} requests)")
        check(set(st["endpoint_seconds"]) == set(endpoints), f"stats {st}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    print(f"[serve] kernel launches of the {requests - warm} requests after the warmup: "
          f"{by_flags_str(launches)}", flush=True)
    for flags in MAIN_SPECS:
        check(launches.get(flags, 0) > 0, f"serving never launched the kernel {flags}")

    for b in SERVE_BUCKETS:
        x_np = gp.equation.geometry().sample_domain(gen, b, device=dev).cpu().numpy()
        p50 = {}
        for ep in endpoints:
            fn = getattr(server, ep)
            times = []
            for _ in range(SERVE_REPEATS):
                t0 = time.perf_counter()
                fn(x_np)  # returns numpy: the device has finished
                times.append(1e3 * (time.perf_counter() - t0))
            p50[ep] = statistics.median(times)
        print(f"[serve] {smi}; bucket {b}: p50 over {SERVE_REPEATS} requests (host clock, "
              "Python endpoint): " + ", ".join(f"{ep} {v:.3f} ms" for ep, v in p50.items()),
              flush=True)
    return launches


def debug_phase(dev, smi, gp):
    """Phase 11: a full-history u_solve(2, 2, M=3) under --debug-checks."""
    import torch

    from scasml_gp_torch.gp import fused_posterior as fp
    from scasml_gp_torch.picard.scasml import ScaSMLFullHistory
    from scasml_gp_torch.utils.debug import FloatCheckError

    gen = torch.Generator(device=dev).manual_seed(13)
    x = torch.cat(gp.equation.generate_test_data(N_TEST_DOM, N_TEST_BDY, gen, device=dev))
    solvers = {k: ScaSMLFullHistory(gp.equation, gp, seed=5, debug_checks=k)
               for k in (False, True)}
    outs, secs, launches = {}, {}, {}
    for k, sca in solvers.items():
        sca.u_solve(2, 2, x, M=3)  # warm-up
        sca.gen.manual_seed(5)
        torch.cuda.synchronize()
        fp.reset_launches()
        t0 = time.perf_counter()
        outs[k] = sca.u_solve(2, 2, x, M=3)
        torch.cuda.synchronize()
        secs[k] = time.perf_counter() - t0
        launches[k] = dict(fp.launches_by_flags)
    check(torch.equal(outs[True], outs[False]),
          "the checked solve differs from the unchecked one")
    check(launches[True] == launches[False] == EXPECTED_FH_SOLVE_LAUNCHES,
          f"kernel launches checked {launches[True]}, unchecked {launches[False]}")
    x_nan = x.clone()
    x_nan[7, 3] = float("nan")
    try:
        solvers[True].u_solve(2, 2, x_nan, M=3)
    except FloatCheckError as e:
        raised = str(e)
    else:
        raised = None
    check(raised is not None and "nan generated by aten op aten." in raised,
          f"a NaN input row raised {raised!r}")
    print(f"[debug] {smi}; ScaSMLFullHistory u_solve(2, 2, M=3) on {x.shape[0]} points: "
          f"checked {1e3 * secs[True]:.3f} ms, unchecked {1e3 * secs[False]:.3f} ms "
          f"({secs[True] / secs[False]:.1f}x, host clock, synchronized), bitwise equal, "
          f"kernel launches {by_flags_str(launches[True])} in each; a NaN in row 7 "
          f"raised: {raised}", flush=True)
    return launches[True]


# Phase 12.  The data axis is held to world 1 at the JAX package's sharding
# bar (tests/test_sharding.py: the same numbers, gathered), the model axis
# at its precision bar (tests/test_precision.py:119: partial sums over the
# training rows added in another order).
MESH_SEED = 11
MESH_DATA = dict(rtol=1e-4, atol=1e-5)
MESH_MODEL = dict(rtol=2e-3, atol=2e-4)
MESH_CHILD_TIMEOUT_S = 300


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_phase(dev, smi, gp, x_dom, x_bdy, x_test):
    """Phase 12: (a) make_sharded_train_and_solve on a 1 x 1 mesh of a
    one-process NCCL world against the unsharded path, bitwise; (b) two gloo
    processes on this card at 2 x 1 and 1 x 2 against world 1.  Returns the
    kernel launches of (a) and of each rank of (b)."""
    import torch
    import torch.distributed as dist

    from scasml_gp_torch.gp import fused_posterior as fp
    from scasml_gp_torch.parallel import make_mesh, make_sharded_train_and_solve
    from scasml_gp_torch.picard.core import build_quadrature_uz
    from scasml_gp_torch.picard.scasml import ScaSML
    from scasml_gp_torch.picard.schedule import approx_parameters

    eq = gp.equation
    sca = ScaSML(eq, gp)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1)
        check(dist.get_backend() == "nccl" and mesh.shape == {"data": 1, "model": 1},
              f"world {dist.get_backend()} x {dist.get_world_size()}, mesh {mesh.shape}")
        step = make_sharded_train_and_solve(eq, gp, sca, mesh, n=2, rho=2, gn_steps=20)
        torch.cuda.synchronize()
        fp.reset_launches()
        t0 = time.perf_counter()
        u = step(x_dom, x_bdy, x_test, torch.Generator(device=dev).manual_seed(MESH_SEED))
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = dict(fp.launches_by_flags)
    finally:
        dist.destroy_process_group()
    gp.GPsolver(x_dom, x_bdy)
    uz = build_quadrature_uz(sca._model(), 2, 2, approx_parameters(2, eq.T))(
        x_test, torch.Generator(device=dev).manual_seed(MESH_SEED), gp.state)
    u_ref = gp.predict(x_test) + uz[:, :1]
    check(torch.equal(u, u_ref), "the 1 x 1 sharded step differs from the unsharded path: "
          f"max {float((u - u_ref).abs().max()):.3g}")
    e = rel_l2(u, eq.exact_solution(x_test))
    print(f"[mesh] {smi}; (a) NCCL world of 1, 1 x 1 mesh: make_sharded_train_and_solve "
          f"(20 Newton steps, quadrature ScaSML (2, 2), {x_test.shape[0]} points) in "
          f"{step_s:.3f} s (host clock, first call), bitwise equal to the unsharded path; "
          f"rel-L2 {e:.6f}; kernel launches {by_flags_str(launches)}", flush=True)
    check(launches == EXPECTED_LAUNCHES, f"the step's launches {launches}")

    port = free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-child",
                               str(rank), str(port)], cwd=here, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MESH_CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("MESHRESULT ")]
        check(p.returncode == 0 and lines, f"mesh rank {rank} failed:\n{out[-4000:]}")
        results.append(json.loads(lines[-1][len("MESHRESULT "):]))
    for r in results:
        print(f"[mesh] {smi}; (b) gloo rank {r['rank']} of 2 on cuda:0: ScaSMLFullHistory "
              f"u_solve(2, 2, M=3) on {r['rows']} points: world 1 {r['solve_ms']['1x1']:.3f} ms, "
              f"2 x 1 {r['solve_ms']['2x1']:.3f} ms (max abs diff {r['diff']['2x1']:.3g}), "
              f"1 x 2 {r['solve_ms']['1x2']:.3f} ms (max abs diff {r['diff']['1x2']:.3g}); "
              f"dense train world 1 {r['train_s']['1x1']:.3f} s, 1 x 2 {r['train_s']['1x2']:.3f} s "
              f"(weights bitwise equal: {r['train_bitwise']}; prediction max abs diff "
              f"{r['diff']['train']:.3g}); host clock, "
              "synchronized, two ranks sharing one card", flush=True)
        print(f"[mesh] rank {r['rank']} kernel launches: " + ", ".join(
            f"{k} {v}" for k, v in r["launches"].items()), flush=True)
        for k in ("2x1", "1x2"):
            check(r["launches"][k] and all(v for v in r["launches"][k].values()),
                  f"rank {r['rank']} launched no kernel at {k}")
    check(all(r["train_bitwise"] for r in results),
          "the 1 x 2 dense train's weights differ from world 1's")
    check(results[0]["checksum"] == results[1]["checksum"],
          f"the ranks' solves differ: {[r['checksum'] for r in results]}")
    return {"a": launches, "b": [r["launches"] for r in results]}


def mesh_child(rank, port):
    """One of phase 12b's two ranks on cuda:0 (gloo); prints MESHRESULT."""
    import torch
    import torch.distributed as dist

    import scasml_gp_torch as port_pkg
    from scasml_gp_torch.gp import fused_posterior as fp
    from scasml_gp_torch.parallel import initialize_distributed, make_mesh
    from scasml_gp_torch.picard.scasml import ScaSMLFullHistory
    from scasml_gp_torch.serve import load_surrogate

    dev = torch.device("cuda", 0)
    initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo")
    try:
        gp = load_surrogate(SERVE_DIR, device=dev)
        eq = gp.equation
        x = torch.cat(eq.generate_test_data(
            N_TEST_DOM, N_TEST_BDY, torch.Generator(device=dev).manual_seed(13), device=dev))
        mesh_d, mesh_m = make_mesh(2, 1), make_mesh(1, 2)
        gp_m = load_surrogate(SERVE_DIR, device=dev, mesh=mesh_m)
        res = {"rank": rank, "rows": x.shape[0], "solve_ms": {}, "launches": {}, "diff": {},
               "train_s": {}}
        us = {}
        for key, g, mesh in (("1x1", gp, None), ("2x1", gp, mesh_d), ("1x2", gp_m, mesh_m)):
            sca = ScaSMLFullHistory(eq, g, seed=MESH_SEED, mesh=mesh)
            sca.u_solve(2, 2, x, M=3)  # warm-up
            sca.gen.manual_seed(MESH_SEED)
            torch.cuda.synchronize()
            fp.reset_launches()
            t0 = time.perf_counter()
            us[key] = sca.u_solve(2, 2, x, M=3)
            torch.cuda.synchronize()
            res["solve_ms"][key] = 1e3 * (time.perf_counter() - t0)
            res["launches"][key] = by_flags_str(fp.launches_by_flags)
        for key, tol in (("2x1", MESH_DATA), ("1x2", MESH_MODEL)):
            torch.testing.assert_close(us[key], us["1x1"], **tol)
            res["diff"][key] = float((us[key] - us["1x1"]).abs().max())
        x_dom, x_bdy = eq.generate_data(N_DOM, N_BDY,
                                        torch.Generator(device=dev).manual_seed(1234),
                                        device=dev)
        preds, weights = {}, {}
        for key, mesh in (("1x1", None), ("1x2", mesh_m)):
            g = port_pkg.GPGradDependentNonlinear(eq, gp.config, device=dev, mesh=mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g.GPsolver(x_dom, x_bdy)
            torch.cuda.synchronize()
            res["train_s"][key] = time.perf_counter() - t0
            preds[key], weights[key] = g.predict(x), g.state.right_vector
        # the gathered Gram is gram_matrix's bit for bit, so is the train
        res["train_bitwise"] = bool(torch.equal(weights["1x2"], weights["1x1"]))
        torch.testing.assert_close(preds["1x2"], preds["1x1"], **MESH_MODEL)
        res["diff"]["train"] = float((preds["1x2"] - preds["1x1"]).abs().max())
        res["checksum"] = float(us["2x1"].double().sum())
        print("MESHRESULT " + json.dumps(res), flush=True)
    except Exception:
        import traceback

        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)  # the other rank may wait in a collective
    dist.destroy_process_group()


# Phase 13.
BF16_DIR = "results/smoke_bf16"


def bf16_phase(dev, smi, bench, tuned_state):
    """Phase 13: the bf16-operand kernel variant against its plain version
    at the bench GP's and at phase 5's full-history shapes, its distance
    from the float32 kernel, and the flagless full-history runner with
    --bf16 against phase 5's float32 run.  Returns the kernel records."""
    import torch

    from scasml_gp_torch.gp import fused_posterior as fp
    from scasml_gp_torch.gp.posterior import posterior_block
    from scasml_gp_torch.harness import runner

    bf16 = torch.bfloat16
    eq_x_dom, eq_x_bdy, r, gamma, geom = bench
    cases = {
        "bench": (eq_x_dom, eq_x_bdy, r, gamma,
                  {f: n for f, (_, n) in MAIN_SPECS.items()} | {(True, True): 1200}),
        "full_history": (tuned_state.x_dom, tuned_state.x_bdy, tuned_state.right_vector,
                         tuned_state.gamma,
                         {f: n for f, (_, n) in FH_SPECS.items()} | {(True, True): 3600}),
    }
    gen = torch.Generator(device=dev).manual_seed(21)
    records = {}
    for where, (xd, xb, rv, gm, rows) in cases.items():
        f16 = fp.prepare_inputs(xd, xb, rv, gm, D, operand_dtype=bf16)
        f32 = fp.prepare_inputs(xd, xb, rv, gm, D)
        for flags, n in rows.items():
            x = geom.sample_domain(gen, n, device=dev)
            errs = compare_kernel(x, f16, xd, xb, rv, gm, D, flags,
                                  f"bf16 {where} n={n}", repeat=True)
            rec = kernel_record(x, f16, flags, lambda: posterior_block(
                x, xd, xb, rv, gm, D, *flags, operand_dtype=bf16), errs)
            a, b = fp.fused_posterior(x, f16, *flags), fp.fused_posterior(x, f32, *flags)
            rec["vs_float32"] = {
                name: {"max_abs": float((u - v).abs().max()),
                       "rel_l2": float((u - v).norm() / v.norm())}
                for name, u, v in zip(a._fields, a, b) if v is not None}
            records[where, flags] = rec
            print(f"[bf16] {smi}; {where} (want_grad={flags[0]:d}, want_ops={flags[1]:d}) "
                  f"n={n}: {describe(rec)}; against the float32 kernel: " + ", ".join(
                      f"{k} rel {v['rel_l2']:.3g} (max {v['max_abs']:.3g})"
                      for k, v in rec["vs_float32"].items()), flush=True)

    with open(os.path.join(RUN_DIR, "GradDependentNonlinear", f"{D}d", "full_history",
                           "SimpleUniform", "metrics.json")) as fh:
        rel32 = {k: v["rel_L2"] for k, v in json.load(fh)["metrics"].items()}
    torch.cuda.synchronize()
    fp.reset_launches()
    t0 = time.perf_counter()
    out = runner.main(["--dim", str(D), "--variant", "full_history", "--harness",
                       "SimpleUniform", "--save-path", BF16_DIR, "--device", "cuda",
                       "--no-plots", "--bf16"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches16, launches32 = dict(fp.bf16_launches_by_flags), dict(fp.launches_by_flags)
    rel16 = {k: v["rel_L2"] for k, v in out["metrics"].items()}
    print(f"[bf16] {smi}; runner --bf16 (flagless: the float32 tune, then the run with "
          f"the bf16 policy) in {run_s:.3f} s; rel-L2 bf16 / float32 (phase 5): " + ", ".join(
              f"{k} {rel16[k]:.6f} / {rel32[k]:.6f}" for k in SOLVERS), flush=True)
    print(f"[bf16] kernel launches: bf16 variant {by_flags_str(launches16)} (the run), "
          f"float32 {by_flags_str(launches32)} (the tune)", flush=True)
    check(abs(rel16["GP"] - rel32["GP"]) < 0.25 * rel32["GP"],
          f"bf16 GP {rel16['GP']} against float32 {rel32['GP']}")
    check(rel16["SCaSML"] < rel16["GP"], f"bf16 SCaSML {rel16['SCaSML']} not below GP")
    for flags in MAIN_SPECS:
        check(launches16.get(flags, 0) > 0, f"the bf16 run never launched the bf16 kernel {flags}")
    for (where, flags), rec in records.items():
        rec["launches"] = launches16.get(flags, 0) if where == "bench" else None
    return records


def parity_phase(dev, smi, gp_exact, x_dom, x_bdy, x_test):
    """Phase 14: the parity modes on the bench points and the Monte-Carlo
    parity probes on 1200 points."""
    import torch

    import scasml_gp_torch as port
    from scasml_gp_torch.gp import fused_posterior as fp
    from scasml_gp_torch.gp.parity import parity_factorization, parity_gram_matrix

    eq = gp_exact.equation
    exact = eq.exact_solution(x_test)
    for fp16 in (False, True):
        gp = port.GPGradDependentNonlinear(
            eq, port.GPConfig(gn_steps=20, laplacian="subset", parity_fp16=fp16), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        K = parity_gram_matrix(x_dom, x_bdy, gp.gamma[0], gp._subset, D, fp16)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, C = parity_factorization(K, gp.nugget, fp16)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(bool(torch.isfinite(C).all()), "parity factorization not finite")
        gp.GPsolver(x_dom, x_bdy)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t2
        e_gp = rel_l2(gp.predict(x_test), exact)
        sca = port.ScaSML(eq, gp, seed=7)
        fp.reset_launches()
        u = sca.u_solve(2, 2, x_test)
        torch.cuda.synchronize()
        check(fp.launches == 0, "the parity posterior launched the fused kernel")
        e_sca = rel_l2(u, exact)
        print(f"[parity] {smi}; laplacian='subset' (subset {gp._subset}), parity_fp16="
              f"{fp16}: biased Gram ({K.shape[0]}^2) {t1 - t0:.3f} s, fp64 eigh "
              f"pseudo-Cholesky on the card {t2 - t1:.3f} s, GPsolver (20 Newton steps) "
              f"{train_s:.3f} s (host clock, synchronized); GP rel-L2 {e_gp:.6f}, "
              f"quadrature ScaSML (2, 2) {e_sca:.6f}", flush=True)
        check(math.isfinite(e_gp) and e_gp < 0.5 and e_sca < e_gp,
              f"parity fp16={fp16}: GP {e_gp}, ScaSML {e_sca}")
    with open("reports/quadrature_parity.json") as fh:
        jax_q = {v["variant"]: v for v in json.load(fh)["variants"]}
    probes = {
        "ScaSML terminal_crn": port.ScaSML(eq, gp_exact, seed=7, terminal_crn=True),
        "MLP terminal_crn": port.MLP(eq, device=dev, seed=7, terminal_crn=True),
        "MLP terminal_crn + reference_semantics + float16 paths": port.MLP(
            eq, device=dev, seed=7, terminal_crn=True, reference_semantics=True,
            precision=port.PrecisionPolicy(rollout="float16")),
    }
    jax_of = {"MLP terminal_crn": "crn",
              "MLP terminal_crn + reference_semantics + float16 paths": "combined_faithful"}
    for name, solver in probes.items():
        e = rel_l2(solver.u_solve(2, 2, x_test), exact)
        j = jax_q.get(jax_of.get(name))
        ref = (f"; the JAX package's {j['reps']}-rep mean {j['mean']:.4f} (std "
               f"{j['std']:.4f})" if j else "")
        print(f"[parity] {smi}; {name}, quadrature (2, 2) on {x_test.shape[0]} points: "
              f"rel-L2 {e:.6f}{ref}", flush=True)
        check(math.isfinite(e) and e < 0.5, f"{name}: rel-L2 {e}")


DRIVERS_DIR = "results/smoke_drivers"
HIGH_D = 250
HIGH_D_N_TEST = 500  # --n-test: 500 + 100 test points
# The posterior calls of high_dim grad_dep: GPsolver's predict at its 1000
# training points, the GP's predict at the 600 test points, then one
# ScaSMLFullHistory u_solve(2, M=3) there (as FH_SPECS at 1200 points;
# pinned on the CPU by counting GP.posterior_u).  The path launches no
# grad+ops call: that specialisation is held on the rows of the gradient call.
HIGH_D_FLAGS = ((False, False), (True, False), (False, True), (True, True))
EXPECTED_HIGH_D_LAUNCHES = {k: v + 2 * (k == (False, False))
                            for k, v in EXPECTED_FH_SOLVE_LAUNCHES.items()}
# run_all's RepeatedExperiment row: the tune, GPsolver's predict, then 10
# repetitions, each a predict and a full-history u_solve
EXPECTED_CAMPAIGN_LAUNCHES = {
    k: v + (k == (False, False)) + 10 * (EXPECTED_FH_SOLVE_LAUNCHES[k] + (k == (False, False)))
    for k, v in EXPECTED_TUNE_LAUNCHES.items()}
THROUGHPUT_KEYS = ["d", "batch", "n", "M", "evals_per_call", "single_device_s",
                   "gsamples_per_sec_per_device"]


def float64_errors(x, fused, st, d, flags):
    """Max abs error by output of the kernel and of the float32 plain
    version against the float64 plain evaluation of the same function, and
    the largest ratio of the kernel's error to the kernel-vs-plain bar
    (2e-4 + 2e-4 |float64 value|)."""
    import torch

    from scasml_gp_torch.gp import fused_posterior as fp
    from scasml_gp_torch.gp.posterior import posterior_block

    args = (x, st.x_dom, st.x_bdy, st.right_vector, st.gamma, d, *flags)
    ref = posterior_block(*args, operand_dtype=torch.float64)
    plain = posterior_block(*args)
    kern = fp.fused_posterior(x, fused, *flags)
    out = {}
    for name, k, p, r in zip(ref._fields, kern, plain, ref):
        if r is None:
            continue
        ek, ep = (k.double() - r).abs(), (p.double() - r).abs()
        out[name] = {"kernel": float(ek.max()), "plain": float(ep.max()),
                     "kernel_over_bar": float((ek / (ATOL + RTOL * r.abs())).max())}
    return out


def drivers_phase(smi):
    """Phase 15: the experiment drivers (scasml_gp_torch.scripts) through
    their mains, and the kernel at F = 251 on high_dim grad_dep's trained GP
    and the rows it launched, against its plain version (and both against a
    float64 evaluation).  Returns the F = 251 kernel records."""
    import torch

    from scasml_gp_torch.gp import fused_posterior as fp
    from scasml_gp_torch.gp.posterior import posterior_block
    from scasml_gp_torch.picard.schedule import count_evaluations_full_history
    from scasml_gp_torch.scripts import high_dim, run_all, summarize_campaign, throughput

    # 15a. one campaign row, flagless: the tune, then RepeatedExperiment
    tag = f"GradDependentNonlinear/{D}d/full_history/RepeatedExperiment"
    torch.cuda.synchronize()
    fp.reset_launches()
    t0 = time.perf_counter()
    run_all.main(["--dims", str(D), "--variants", "full_history", "--harness",
                  "RepeatedExperiment", "--save-path", DRIVERS_DIR, "--device", "cuda",
                  "--no-plots"])
    torch.cuda.synchronize()
    campaign_s = time.perf_counter() - t0
    campaign_launches = dict(fp.launches_by_flags)
    with open(os.path.join(DRIVERS_DIR, "run_all_summary.json")) as fh:
        summary = json.load(fh)
    bad = {k: row["error"] for k, row in summary.items() if "error" in row}
    check(not bad, f"run_all rows failed: {bad}")
    rel = summary[tag]["metrics"]["rel_L2"]
    print(f"[drivers] {smi}; run_all {tag} (tune + 10 repetitions) in {campaign_s:.3f} s: "
          f"rel-L2 GP {rel['GP']:.6f}, MLP {rel['MLP']:.6f}, SCaSML {rel['SCaSML']:.6f}; "
          f"kernel launches {by_flags_str(campaign_launches)}", flush=True)
    check(rel["GP"] < 0.06 and rel["SCaSML"] < rel["GP"] and rel["MLP"] < 0.30,
          f"run_all row rel-L2 {rel}")
    check(campaign_launches == EXPECTED_CAMPAIGN_LAUNCHES,
          f"run_all launches {campaign_launches} != {EXPECTED_CAMPAIGN_LAUNCHES}")

    # 15b. the campaign's table
    table = summarize_campaign.main(["--save-path", DRIVERS_DIR])
    check(f"| GradDependentNonlinear | {D}d | full_history | {rel['GP']:.4f} |" in table,
          "summarize_campaign did not print the run_all row")

    # 15c. throughput at d=100
    res = throughput.main(["--d", "100", "--reps", "2", "--device", "cuda"])
    check(list(res) == THROUGHPUT_KEYS, f"throughput keys {list(res)}")
    check(res["evals_per_call"] == count_evaluations_full_history(3, 4)
          and res["gsamples_per_sec_per_device"] > 0, f"throughput {res}")
    print(f"[drivers] {smi}; throughput d=100, batch 1200, (n, M) = (3, 4), 2 reps: "
          f"{res['single_device_s'] * 1e3:.3f} ms a call, "
          f"{res['gsamples_per_sec_per_device']:.6f} G evaluations/s", flush=True)

    # 15d. high_dim grad_dep at d=250: the kernel at F = 251. The kernel's
    # inputs are recorded as high_dim launches it, so 15e holds the kernel
    # to its plain version on the rollout's own rows and on the GP it ran.
    launched, keep, wrapper = {}, {}, fp.fused_posterior

    def recording(x, fused, want_grad=False, want_ops=False):
        flags = (want_grad, want_ops)
        if x.shape[0] > launched.get(flags, (torch.empty(0),))[0].shape[0]:
            launched[flags] = (x.clone(), fused)
        return wrapper(x, fused, want_grad, want_ops)

    torch.cuda.synchronize()
    fp.reset_launches()
    fp.fused_posterior = recording
    try:
        hd = high_dim.main(["--equation", "grad_dep", "--dim", str(HIGH_D), "--n-test",
                            str(HIGH_D_N_TEST), "--out", DRIVERS_DIR, "--device", "cuda"],
                           keep=keep)
        torch.cuda.synchronize()
    finally:
        fp.fused_posterior = wrapper
    hd_launches = dict(fp.launches_by_flags)
    print(f"[drivers] {smi}; high_dim grad_dep d={HIGH_D} (untuned, 1000 + 200 points, "
          f"{hd['n_test']} test points): rel-L2 " + ", ".join(
              f"{k} {v:.6f}" for k, v in hd["rel_L2"].items())
          + f"; wall s {hd['wall_s']}; kernel launches {by_flags_str(hd_launches)}",
          flush=True)
    check(all(math.isfinite(v) for v in hd["rel_L2"].values()), f"high_dim {hd}")
    check(hd_launches == EXPECTED_HIGH_D_LAUNCHES,
          f"high_dim launches {hd_launches} != {EXPECTED_HIGH_D_LAUNCHES}")

    # 15e. the kernel at F = 251 against its plain version, on the GP that
    # high_dim trained and the largest call of each specialisation it made
    st = keep["gp"].state
    records = {}
    for flags in HIGH_D_FLAGS:
        x, fused = launched[flags if flags in launched else (True, False)]
        n = x.shape[0]
        check(torch.equal(fused.cols, st.fused_inputs().cols),
              f"high_dim's {flags} call ran on inputs other than its GP's")
        f64 = float64_errors(x, fused, st, HIGH_D, flags)
        print(f"[drivers] F={HIGH_D + 1} (want_grad={flags[0]:d}, want_ops={flags[1]:d}) "
              f"n={n}, against a float64 evaluation: " + ", ".join(
                  f"{k} kernel {v['kernel']:.3g} / plain {v['plain']:.3g} (kernel / bar "
                  f"{v['kernel_over_bar']:.3g})" for k, v in f64.items()), flush=True)
        errs = compare_kernel(x, fused, st.x_dom, st.x_bdy, st.right_vector, st.gamma,
                              HIGH_D, flags, f"high_dim GP d={HIGH_D}, n={n}", repeat=True)
        rec = kernel_record(x, fused, flags, lambda: posterior_block(
            x, st.x_dom, st.x_bdy, st.right_vector, st.gamma, HIGH_D, *flags), errs)
        rec["launches"] = hd_launches.get(flags, 0)
        rec["vs_float64"] = f64
        records[flags] = rec
        print(f"[drivers] {smi}; kernel (want_grad={flags[0]:d}, want_ops={flags[1]:d}) "
              f"n={n}, F={HIGH_D + 1}, high_dim's GP and rows: {describe(rec)}", flush=True)
    return records, {f: campaign_launches.get(f, 0) for f in MAIN_SPECS}


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
    # ptxas -v per kernel: registers and spills of each specialisation
    kernel, spills, spill_bytes = None, 0, "?"
    for line in build.build_log.splitlines():
        m = re.search(r"fused_posterior_(kernel|reduce)"
                      r"(?:ILb(\d)ELb(\d)ELi(\d+)ELb(\d)E)?", line)
        if "Compiling entry function" in line and m:
            kernel = (f"fused_posterior_{m.group(1)}" + (
                f"<grad={m.group(2)}, ops={m.group(3)}, NC={m.group(4)}, "
                f"bf16={m.group(5)}>" if m.group(2) else ""))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills += int(m.group(1)) > 0
            spill_bytes = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m:
            print(f"[build] ptxas: {kernel}: {m.group(1)} registers, "
                  f"{spill_bytes} bytes spill stores", flush=True)
    print(f"[build] specialisations that spill: {spills}", flush=True)

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
    max_err = {f: {} for f in FLAGS}
    for gname, gamma in gammas.items():
        fused = fp.prepare_inputs(x_dom, x_bdy, r, gamma, D)
        for n, x in xs.items():
            for flags in FLAGS:
                errs = compare_kernel(x, fused, x_dom, x_bdy, r, gamma, D, flags,
                                      f"{gname}, n={n}", repeat=True)
                for k, v in errs.items():
                    max_err[flags][k] = max(max_err[flags].get(k, 0.0), v)
    print(f"[kernel] 2 gammas x {len(ROWS)} row counts x 4 specialisations "
          f"agree with posterior_block at rtol=atol={RTOL} and repeat bitwise; "
          f"max abs err by (want_grad, want_ops): "
          f"{by_flags_str({f: max(e.values()) for f, e in max_err.items()})}",
          flush=True)

    gamma = gammas["isotropic"]
    fused = fp.prepare_inputs(x_dom, x_bdy, r, gamma, D)
    times = {}
    for flags, (caller, n) in MAIN_SPECS.items():
        x = xs[n]
        times[flags] = kernel_record(x, fused, flags, lambda: posterior_block(
            x, x_dom, x_bdy, r, gamma, D, *flags), max_err[flags])
        print(f"[kernel] {caller} (want_grad={flags[0]:d}, want_ops={flags[1]:d}) "
              f"n={n}: {describe(times[flags])}", flush=True)

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
    fh, tuned, tuned_gp = runner_phase(dev, smi)

    # 6. the three other PDE families at d=100
    extra = extra_phase(dev, smi)

    # 7. --fit-ml at d=20
    fit_ml = fit_ml_phase(dev, smi)

    # 8. the four sweep harnesses with the tuned config of phase 5
    sweeps = sweeps_phase(dev, smi, tuned)

    # 9. the large-N trainer: against the dense one, then the runner at N = 8192
    large_n = large_n_phase(dev, smi)

    # 10. serving phase 5's tuned surrogate
    serve_launches = serve_phase(dev, smi, tuned_gp)

    # 11. --debug-checks
    debug_launches = debug_phase(dev, smi, tuned_gp)

    # 12. the mesh: a one-process NCCL world, then two gloo ranks on this card
    mesh_launches = mesh_phase(dev, smi, gp, x_dom, x_bdy, x_test)

    # 13. the bf16-operand kernel variant and runner --bf16
    bf16 = bf16_phase(dev, smi, (x_dom, x_bdy, r, gamma, geom), tuned_gp.state)

    # 14. the parity modes and probes
    parity_phase(dev, smi, gp, x_dom, x_bdy, x_test)

    # 15. the experiment drivers, and the kernel at F = 251
    wide, campaign_launches = drivers_phase(smi)

    kernels = []
    for f, (caller, _) in MAIN_SPECS.items():
        rec = {
            "name": f"fused_posterior[{caller}: want_grad={f[0]:d} want_ops={f[1]:d}]",
            "route": "cuda",
            "source": "scasml_gp_torch/csrc/fused_posterior.cu",
            "replaces": REPLACES,
            "launches": by_flags.get(f, 0),
            **{k: times[f][k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by", "share_of_bound",
                                        "library_ms", "device_ms", "rows", "splits")},
            "full_history": fh[f],
            "sine_d100": extra[f],
            "fit_ml": fit_ml[f],
            "sweeps": sweeps[f],
            "large_n": large_n[f],
            "serve": {"launches": serve_launches.get(f, 0)},
            "debug_checks": {"launches": debug_launches.get(f, 0)},
            "mesh": {"launches_1x1_step": mesh_launches["a"].get(f, 0),
                     "launches_by_rank": [r[k].get(f"{f[0]:d}{f[1]:d}", 0)
                                          for r in mesh_launches["b"] for k in r]},
            "run_all": {"launches": campaign_launches[f]},
        }
        if f == (True, False):  # the gradient kernel with the operators on too
            rec["sine_d100_with_ops"] = extra[(True, True)]
        kernels.append(rec)
    for f, (caller, _) in MAIN_SPECS.items():
        b = bf16["bench", f]
        kernels.append({
            "name": f"fused_posterior_bf16[{caller}: want_grad={f[0]:d} want_ops={f[1]:d}]",
            "route": "cuda",
            "source": "scasml_gp_torch/csrc/fused_posterior.cu",
            "replaces": REPLACES,
            **{k: b[k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "share_of_bound", "library_ms", "device_ms",
                                 "rows", "splits", "vs_float32")},
            "full_history": bf16["full_history", f],
        })
    kernels[-2]["with_ops"] = {"bench": bf16["bench", (True, True)],
                               "full_history": bf16["full_history", (True, True)]}
    for f, (caller, _) in MAIN_SPECS.items():
        kernels.append({
            "name": f"fused_posterior[high_dim F={HIGH_D + 1} {caller}: "
                    f"want_grad={f[0]:d} want_ops={f[1]:d}]",
            "route": "cuda",
            "source": "scasml_gp_torch/csrc/fused_posterior.cu",
            "replaces": REPLACES,
            **wide[f],
        })
    kernels[-2]["with_ops"] = wide[(True, True)]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--mesh-child":
        mesh_child(int(sys.argv[2]), int(sys.argv[3]))
    else:
        sys.exit(main())
