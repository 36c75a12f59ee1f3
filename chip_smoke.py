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
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero; there
is no CPU path.  Imports neither JAX nor the JAX package.
"""

import json
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


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def rel_l2(pred, exact):
    pred, exact = pred.reshape(-1).double(), exact.reshape(-1).double()
    return float((pred - exact).norm() / exact.norm())


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
            for wg, wo in FLAGS:
                got = fp.fused_posterior(x, fused, wg, wo)
                ref = posterior_block(x, x_dom, x_bdy, r, gamma, D, wg, wo)
                torch.cuda.synchronize()
                for name, a, b in zip(ref._fields, got, ref):
                    check((a is None) == (b is None), f"{name} presence differs")
                    if b is None:
                        continue
                    check(a.shape == b.shape, f"{name} shape {a.shape} != {b.shape}")
                    err = (a - b).abs()
                    bad = err > ATOL + RTOL * b.abs()
                    check(bool(torch.isfinite(a).all()), f"{name} not finite")
                    check(not bool(bad.any()),
                          f"kernel != plain for {name} ({gname}, n={n}, "
                          f"want_grad={wg}, want_ops={wo}): max err "
                          f"{float(err.max()):.3g}")
                    max_err[(wg, wo)] = max(max_err[(wg, wo)], float(err.max()))
    print(f"[kernel] 2 gammas x {len(ROWS)} row counts x 4 specialisations "
          f"agree with posterior_block at rtol=atol={RTOL}; max abs err by "
          f"(want_grad, want_ops): "
          f"{ {f'{k[0]:d}{k[1]:d}': v for k, v in max_err.items()} }", flush=True)

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
          f"{ {f'{k[0]:d}{k[1]:d}': v for k, v in sorted(by_flags.items())} }",
          flush=True)
    check(launches > 0, "the main path launched no kernel")
    check(launches == sum(EXPECTED_LAUNCHES.values()),
          f"{launches} launches, expected {sum(EXPECTED_LAUNCHES.values())}")
    check(by_flags == EXPECTED_LAUNCHES,
          f"launches by specialisation {by_flags} != {EXPECTED_LAUNCHES}")
    check(0.10 <= e_gp <= 0.20, f"GP rel-L2 {e_gp} outside [0.10, 0.20]")
    check(e_sca < e_gp and e_sca < 0.10,
          f"ScaSML rel-L2 {e_sca} not below GP {e_gp} and 0.10")

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
