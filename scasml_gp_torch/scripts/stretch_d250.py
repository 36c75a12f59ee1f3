"""HJB and Allen-Cahn at d=250 (the stretch PDEs).

Port of ``scripts/stretch_d250.py``.  Two legs:

    python -m scasml_gp_torch.scripts.stretch_d250 [--device cuda]
        the mesh check: HJB ScaSML full history at d=250 with the test
        batch split over an 8 x 1 ('data', 'model') mesh of gloo processes,
        against the same solve in one process; writes
        reports/torch_d250/mesh_check.json.  Each rank runs on --device (on
        CUDA, rank r on card r mod the card count: all eight share one card).
    python -m scasml_gp_torch.scripts.stretch_d250 --tpu [--device cuda]
        full-size accuracy and wall time on --device (the flag keeps the JAX
        script's name): HJB through the Cole-Hopf semigroup GP (m = 2000),
        MLP and ScaSML at M = 8 and 32, the coarse m = 150 rbf surrogate
        that ScaSML repairs, and Allen-Cahn through the reaction-semigroup
        GP against a deep Picard reference; writes
        reports/torch_d250/d250_full.json.

``--device`` defaults to cuda and a missing CUDA device is an error, in
both legs.  HJB's exact solution is Cole-Hopf Monte Carlo; Allen-Cahn has
no closed form, so its reference is a deeper Picard run
(harness.metrics.mc_reference_solution).  The output directory is not the
JAX script's (``reports/d250_stretch/`` holds the JAX package's results).
Wall times are host clock around work that ends in a device synchronize;
the ``*_incl_compile`` keys keep the JAX script's names and hold the first
call's time (nothing is compiled here).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from scasml_gp_torch.config import GPConfig
from scasml_gp_torch.equations import HJB, AllenCahn
from scasml_gp_torch.gp.cole_hopf import GPHJBColeHopf
from scasml_gp_torch.gp.semigroup import GPAllenCahnSemigroup
from scasml_gp_torch.harness.metrics import mc_reference_solution
from scasml_gp_torch.parallel.sharded import run_gloo_world
from scasml_gp_torch.scripts.high_dim import rel_l2, seeded
from scasml_gp_torch.picard import MLPFullHistory, ScaSMLFullHistory
from scasml_gp_torch.utils.device import resolve_device

D = 250
OUT_DIR = "reports/torch_d250"
MESH_RANKS = 8
# the 'data' axis's bar (tests/test_sharding.py): the ranks roll out the
# same numbers and gather them
MESH_RTOL, MESH_ATOL = 1e-4, 1e-5
MESH_TIMEOUT_S = 600


def _timed(device, fn, *args, **kwargs):
    """fn's result and its wall time, up to the end of its work on ``device``."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def mesh_solves(d: int, mesh, device):
    """(unsharded, sharded) HJB ScaSML full-history u_solve(2, M=4) at dim
    ``d`` on 32 points, on ``device``; both solvers start from the same
    seed, so their draws are the same."""
    eq = HJB(n_input=d + 1)
    gp = GPHJBColeHopf(eq, GPConfig(), device=device)
    x_dom, x_bdy = eq.generate_data(250, 50, seeded(device, 3), device=device)
    gp.GPsolver(x_dom, x_bdy)
    x_test = eq.geometry().sample_domain(seeded(device, 6), 32, device=device)
    u_single = ScaSMLFullHistory(eq, gp).u_solve(2, None, x_test, M=4)
    u_mesh = ScaSMLFullHistory(eq, gp, mesh=mesh).u_solve(2, None, x_test, M=4)
    return u_single.cpu().numpy(), u_mesh.cpu().numpy()


def _mesh_child(rank: int, ranks: int, port: int, d: int, device: str) -> None:
    """One rank of the mesh check; rank 0 prints ``MESHCHECK <json>``."""
    from scasml_gp_torch.parallel.mesh import initialize_distributed, make_mesh

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", ranks, rank, backend="gloo")
    try:
        u_single, u_mesh = mesh_solves(d, make_mesh(data=ranks, model=1), dev)
    finally:
        torch.distributed.destroy_process_group()
    diff = np.abs(u_mesh - u_single)
    scale = float(np.max(np.abs(u_single)))
    summary = {
        "leg": f"gloo {ranks}-process {dev.type.upper()} mesh correctness "
               f"(HJB d={d}, ScaSML FH)",
        "mesh": f"{ranks}x1 (data, model)",
        "n": 2,
        "M": 4,
        "batch": int(u_single.shape[0]),
        "max_abs_diff": float(diff.max()),
        "u_scale": scale,
        "agree": bool(diff.max() < 1e-4 * max(scale, 1.0)),
        "within_data_tolerance": bool(
            np.all(diff <= MESH_ATOL + MESH_RTOL * np.abs(u_single))),
    }
    if rank == 0:
        print("MESHCHECK " + json.dumps(summary), flush=True)


def leg_mesh_check(device="cuda", ranks: int = MESH_RANKS, d: int = D,
                   out_dir: str = OUT_DIR):
    """Sharded against unsharded HJB ScaSML at dim ``d`` on a ('data' =
    ranks) mesh of gloo processes on ``device``; writes mesh_check.json and
    raises unless every rank finished and the solves agree within the
    'data' axis's rtol 1e-4, atol 1e-5."""
    dev = resolve_device(device)
    runs = run_gloo_world("scasml_gp_torch.scripts.stretch_d250._mesh_child", ranks,
                          MESH_TIMEOUT_S, args=(d, str(dev)))
    for rank, (rc, out) in enumerate(runs):
        if rc != 0:
            raise RuntimeError(f"mesh check: rank {rank} failed:\n{out}")
    line = [ln for ln in runs[0][1].splitlines() if ln.startswith("MESHCHECK ")]
    if not line:
        raise RuntimeError(f"mesh check: rank 0 printed no result:\n{runs[0][1]}")
    summary = json.loads(line[0][len("MESHCHECK "):])
    os.makedirs(out_dir, exist_ok=True)
    with open(f"{out_dir}/mesh_check.json", "w") as fh:
        json.dump(summary, fh, indent=2)
    print(json.dumps(summary, indent=2))
    if not summary["within_data_tolerance"]:
        raise RuntimeError(f"mesh check: sharded != unsharded: {summary}")
    return summary


def leg_full_size(device="cuda", out_dir: str = OUT_DIR):
    """Full-size accuracy and wall time on ``device``."""
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)
    print("device:", name, flush=True)
    os.makedirs(out_dir, exist_ok=True)
    results = {}

    # ---- HJB d=250: semigroup GP + MLP + ScaSML vs Cole-Hopf MC ----------
    eq = HJB(n_input=D + 1)
    gp = GPHJBColeHopf(eq, GPConfig(), device=dev)
    x_dom, x_bdy = eq.generate_data(1600, 400, seeded(dev, 3), device=dev)
    _, t_train = _timed(dev, gp.GPsolver, x_dom, x_bdy)
    print(f"HJB GP fit (m=2000): {t_train:.2f}s", flush=True)

    x_test = eq.geometry().sample_domain(seeded(dev, 6), 256, device=dev)
    exact, t_exact = _timed(dev, eq.exact_solution, x_test, num_mc=32768)
    print(f"Cole-Hopf MC exact (32768 samples): {t_exact:.2f}s", flush=True)

    u_gp, t_gp = _timed(dev, gp.predict, x_test)
    rel_gp = rel_l2(u_gp, exact)

    mlp = MLPFullHistory(eq, device=dev)
    u_mlp, t_mlp = _timed(dev, mlp.u_solve, 2, None, x_test, M=8)
    rel_mlp = rel_l2(u_mlp, exact)

    sca = ScaSMLFullHistory(eq, gp)
    u_sca, t_sca = _timed(dev, sca.u_solve, 2, None, x_test, M=8)
    rel_sca = rel_l2(u_sca, exact)
    _, t_sca2 = _timed(dev, sca.u_solve, 2, None, x_test, M=8)  # steady state
    # M=32: the correction's MC variance at the converged-surrogate floor
    u_sca32, _ = _timed(dev, sca.u_solve, 2, None, x_test, M=32)
    rel_sca32 = rel_l2(u_sca32, exact)

    # the coarse-surrogate repair regime: the default mixture backend is
    # exact and data-free, so this leg pins the scattered-rbf backend on 150
    # centers, a coarse surrogate for ScaSML to repair
    gp_c = GPHJBColeHopf(eq, GPConfig(), device=dev, terminal_backend="rbf")
    xdc, xbc = eq.generate_data(120, 30, seeded(dev, 30), device=dev)
    gp_c.GPsolver(xdc, xbc)
    rel_gp_c = rel_l2(gp_c.predict(x_test), exact)
    sca_c = ScaSMLFullHistory(eq, gp_c)
    u_sca_c, _ = _timed(dev, sca_c.u_solve, 2, None, x_test, M=8)
    rel_sca_c = rel_l2(u_sca_c, exact)

    results["hjb"] = {
        "pde": "HJB u_t + Lap u - |grad u|^2 = 0, d=250, T=0.5",
        "surrogate": f"Cole-Hopf semigroup GP ({gp.terminal_backend} "
                     "terminal backend)",
        "n": 2, "M": 8, "test_points": 256,
        "rel_L2": {"GP": rel_gp, "MLP": rel_mlp, "ScaSML": rel_sca,
                   "ScaSML_M32": rel_sca32},
        "repair_regime": {
            "GP_coarse_m150": rel_gp_c,
            "ScaSML_on_coarse": rel_sca_c,
        },
        "improvement_vs_best_baseline_pct": 100.0
        * (min(rel_gp, rel_mlp) - rel_sca) / min(rel_gp, rel_mlp),
        "wallclock_s": {
            "gp_fit": t_train, "gp_predict": t_gp,
            "mlp_solve_incl_compile": t_mlp,
            "scasml_solve_incl_compile": t_sca,
            "scasml_solve_steady": t_sca2,
            "exact_mc_32768": t_exact,
        },
    }
    print(json.dumps(results["hjb"], indent=2), flush=True)

    # ---- Allen-Cahn d=250: reaction-semigroup GP + ScaSML vs deep Picard
    eq2 = AllenCahn(n_input=D + 1)
    gp2 = GPAllenCahnSemigroup(eq2, device=dev)
    xd2, xb2 = eq2.generate_data(400, 100, seeded(dev, 0), device=dev)
    _, t_train2 = _timed(dev, gp2.GPsolver, xd2, xb2)
    print(f"Allen-Cahn GP train: {t_train2:.2f}s", flush=True)

    x_test2 = eq2.geometry().sample_domain(seeded(dev, 1), 128, device=dev)
    ref, t_ref = _timed(dev, mc_reference_solution, eq2, x_test2, n=3, M=8)

    u_gp2, t_gp2 = _timed(dev, gp2.predict, x_test2)
    rel_gp2 = rel_l2(u_gp2, ref)
    mlp2 = MLPFullHistory(eq2, device=dev)
    u_mlp2, t_mlp2 = _timed(dev, mlp2.u_solve, 2, None, x_test2, M=8)
    rel_mlp2 = rel_l2(u_mlp2, ref)
    sca2 = ScaSMLFullHistory(eq2, gp2)
    u_sca2, t_sca2b = _timed(dev, sca2.u_solve, 2, None, x_test2, M=8)
    rel_sca2 = rel_l2(u_sca2, ref)

    results["allen_cahn"] = {
        "pde": "Allen-Cahn u_t + Lap u + u - u^3 = 0, d=250, T=0.3",
        "surrogate": "reaction-semigroup GP (Bernstein mixture, "
                     "gp/semigroup.py)",
        "reference": "deep Picard (n=3, M=8)",
        "n": 2, "M": 8, "test_points": 128,
        "rel_L2": {"GP": rel_gp2, "MLP": rel_mlp2, "ScaSML": rel_sca2},
        "improvement_vs_best_baseline_pct": 100.0
        * (min(rel_gp2, rel_mlp2) - rel_sca2) / min(rel_gp2, rel_mlp2),
        "wallclock_s": {
            "gp_train": t_train2, "gp_predict": t_gp2,
            "mlp_solve_incl_compile": t_mlp2,
            "scasml_solve_incl_compile": t_sca2b,
            "picard_reference_n3_M8": t_ref,
        },
    }
    print(json.dumps(results["allen_cahn"], indent=2), flush=True)

    results["device"] = name
    with open(f"{out_dir}/d250_full.json", "w") as fh:
        json.dump(results, fh, indent=2)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tpu", action="store_true",
                    help="the full-size leg on --device (the JAX script's flag "
                         "name; here it means the card)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of either leg (default cuda; a missing "
                         "CUDA device is an error)")
    args = ap.parse_args(argv)
    if args.tpu:
        return leg_full_size(args.device)
    return leg_mesh_check(args.device)


if __name__ == "__main__":
    main()
