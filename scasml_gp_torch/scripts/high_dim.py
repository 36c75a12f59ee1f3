"""Very-high-dimension runs (d ~ 250).

Port of ``scripts/high_dim.py``, with its flags, defaults, JSON keys and
output path.  Three legs:

  grad_dep   -- GradDependentNonlinear with its exact solution: GP, MLP and
                ScaSML full history (n = 2, M = 3) rel-L2, with the untuned
                kernel or, with --fit-ml, the marginal-likelihood fit.
  allen_cahn -- Allen-Cahn: the collocation GP and ScaSML against a deep
                Picard reference (harness.metrics.mc_reference_solution;
                no closed form exists).
  hjb        -- HJB: full-history MLP at (n, M) = (1, 8), (2, 12), (3, 16)
                against the Cole-Hopf Monte-Carlo solution.

    python -m scasml_gp_torch.scripts.high_dim --equation grad_dep --dim 250 \
        [--fit-ml] [--out reports/highdim] [--device cuda]

Wall times are host clock around work that ends in a device synchronize;
the ``*_incl_compile`` keys keep the JAX script's names and hold the first
call's time (nothing is compiled here).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from scasml_gp_torch.config import GPConfig
from scasml_gp_torch.equations import HJB, AllenCahn, GradDependentNonlinear
from scasml_gp_torch.gp.marginal import fit_gp_marginal_likelihood
from scasml_gp_torch.gp.solver import GPAllenCahn, GPGradDependentNonlinear
from scasml_gp_torch.harness.metrics import mc_reference_solution
from scasml_gp_torch.picard import MLPFullHistory, ScaSMLFullHistory
from scasml_gp_torch.utils.device import resolve_device


def log(*a):
    print(f"[{time.strftime('%H:%M:%S')}]", *a, file=sys.stderr, flush=True)


def rel_l2(a, b):
    """||a - b|| / ||b|| in float64, of tensors or arrays."""
    a = np.asarray(torch.as_tensor(a).detach().cpu(), np.float64).ravel()
    b = np.asarray(torch.as_tensor(b).detach().cpu(), np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def seeded(device, seed):
    """A torch.Generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(seed)


def train_gp(gp_cls, eq, fit_ml: bool, n_train: int, n_train_bdy: int,
             gn_steps, device):
    """(gp, config, train seconds): ``gp_cls`` on ``n_train`` + ``n_train_bdy``
    points drawn with seed 1234, with the default kernel or the fitted one."""
    x_dom, x_bdy = eq.generate_data(n_train, n_train_bdy, seeded(device, 1234),
                                    device=device)
    cfg = GPConfig()
    if fit_ml:
        t0 = time.perf_counter()
        cfg = fit_gp_marginal_likelihood(gp_cls, eq, x_dom, x_bdy, base=cfg,
                                         gn_steps=gn_steps).config
        log(f"fit-ml ({time.perf_counter() - t0:.1f}s): {cfg}")
    gp = gp_cls(eq, cfg, device=device)
    t0 = time.perf_counter()
    gp.GPsolver(x_dom, x_bdy, GN_steps=gn_steps)
    _sync(device)
    t_train = time.perf_counter() - t0
    log(f"GP trained in {t_train:.1f}s")
    return gp, cfg, t_train


def run_grad_dep(d: int, fit_ml: bool, n_test: int, n_train=1000, n_train_bdy=200,
                 gn_steps=None, device="cuda", keep=None):
    """The grad_dep leg's result; a dict ``keep`` also receives the trained
    GP under ``"gp"``."""
    device = resolve_device(device)
    eq = GradDependentNonlinear(n_input=d + 1)
    gp, cfg, t_train = train_gp(GPGradDependentNonlinear, eq, fit_ml, n_train,
                                n_train_bdy, gn_steps, device)
    if keep is not None:
        keep["gp"] = gp

    xt_dom, xt_bdy = eq.generate_test_data(n_test, n_test // 5, seeded(device, 42),
                                           device=device)
    x_test = torch.cat([xt_dom, xt_bdy], dim=0)
    exact = eq.exact_solution(x_test)

    u_gp = gp.predict(x_test)
    mlp = MLPFullHistory(eq, device=device)
    t0 = time.perf_counter()
    u_mlp = mlp.u_solve(2, None, x_test, M=3)
    _sync(device)
    t_mlp = time.perf_counter() - t0
    sca = ScaSMLFullHistory(eq, gp)
    t0 = time.perf_counter()
    u_sca = sca.u_solve(2, None, x_test, M=3)
    _sync(device)
    t_sca = time.perf_counter() - t0

    return {
        "equation": "GradDependentNonlinear",
        "d": d,
        "fit_ml": fit_ml,
        "gp_config": {"gamma_scale": cfg.gamma_scale,
                      "time_scale": cfg.time_scale,
                      "ridge_scale": cfg.ridge_scale, "nugget": cfg.nugget},
        "rel_L2": {"GP": rel_l2(u_gp, exact), "MLP": rel_l2(u_mlp, exact),
                   "SCaSML": rel_l2(u_sca, exact)},
        "wall_s": {"gp_train": round(t_train, 2),
                   "mlp_solve_incl_compile": round(t_mlp, 2),
                   "scasml_solve_incl_compile": round(t_sca, 2)},
        "n_test": int(x_test.shape[0]),
    }


def run_allen_cahn(d: int, fit_ml: bool, n_test: int, n_train=1000, n_train_bdy=200,
                   gn_steps=None, device="cuda"):
    device = resolve_device(device)
    eq = AllenCahn(n_input=d + 1)
    gp, _, t_train = train_gp(GPAllenCahn, eq, fit_ml, n_train, n_train_bdy,
                              gn_steps, device)

    x_test = eq.geometry().sample_domain(seeded(device, 7), n_test, device=device)
    log("building MC reference (deep Picard)...")
    ref = mc_reference_solution(eq, x_test, n=3, M=8)

    u_gp = gp.predict(x_test)
    sca = ScaSMLFullHistory(eq, gp)
    u_sca = sca.u_solve(2, None, x_test, M=4)

    return {
        "equation": "AllenCahn",
        "d": d,
        "fit_ml": fit_ml,
        "rel_vs_mc_reference": {"GP": rel_l2(u_gp, ref), "SCaSML": rel_l2(u_sca, ref)},
        "wall_s": {"gp_train": round(t_train, 2)},
        "n_test": n_test,
        "note": "no closed form; reference = full-history Picard n=3 M=8",
    }


def run_hjb(d: int, n_test: int, device="cuda"):
    device = resolve_device(device)
    eq = HJB(n_input=d + 1)
    gen = seeded(device, 2)
    x = torch.rand((n_test, d), generator=gen, device=device) - 0.5
    t = torch.full((n_test, 1), 0.1, device=device)
    x_t = torch.cat([x, t], dim=1)
    exact = eq.exact_solution(x_t, num_mc=16384)

    out = {"equation": "HJB", "d": d, "rel_L2_vs_cole_hopf": {}, "wall_s": {}}
    for n, M in [(1, 8), (2, 12), (3, 16)]:
        solver = MLPFullHistory(eq, batch_chunk=64, device=device)
        t0 = time.perf_counter()
        u = solver.u_solve(n, None, x_t, M=M)
        _sync(device)
        out["wall_s"][f"n{n}_M{M}"] = round(time.perf_counter() - t0, 2)
        out["rel_L2_vs_cole_hopf"][f"n{n}_M{M}"] = rel_l2(u, exact)
        log(f"HJB n={n} M={M}: rel {out['rel_L2_vs_cole_hopf'][f'n{n}_M{M}']:.4f}")
    return out


def main(argv=None, keep=None):
    """Run one leg and write its JSON; ``keep`` goes to run_grad_dep."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--equation", default="grad_dep",
                        choices=["grad_dep", "allen_cahn", "hjb"])
    parser.add_argument("--dim", type=int, default=250)
    parser.add_argument("--n-test", type=int, default=500)
    parser.add_argument("--fit-ml", action="store_true")
    parser.add_argument("--train-size", type=int, default=1000)
    parser.add_argument("--gn-steps", type=int, default=None)
    parser.add_argument("--out", default="reports/highdim")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; a missing "
                             "CUDA device is an error)")
    args = parser.parse_args(argv)
    resolve_device(args.device)

    n_bdy = max(args.train_size // 5, 8)
    if args.equation == "grad_dep":
        result = run_grad_dep(args.dim, args.fit_ml, args.n_test, args.train_size,
                              n_bdy, args.gn_steps, args.device, keep)
    elif args.equation == "allen_cahn":
        result = run_allen_cahn(args.dim, args.fit_ml, args.n_test, args.train_size,
                                n_bdy, args.gn_steps, args.device)
    else:
        result = run_hjb(args.dim, args.n_test, args.device)

    os.makedirs(args.out, exist_ok=True)
    tag = f"{args.equation}_d{args.dim}" + ("_ml" if args.fit_ml else "")
    path = f"{args.out}/{tag}.json"
    with open(path, "w") as fh:
        json.dump(result, fh, indent=2)
    print(json.dumps(result))
    log(f"written: {path}")
    return result


if __name__ == "__main__":
    main()
