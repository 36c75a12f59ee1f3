"""The experiment campaign: every equation x dimension x variant x harness.

Port of ``scripts/run_all.py``, with its flags, defaults and summary file:

    python -m scasml_gp_torch.scripts.run_all --save-path results \
        --harness RepeatedExperiment [--dims 20 40] \
        [--variants quadrature full_history] [--equations ...] \
        [--no-tune | --fit-ml] [--device cuda] [--no-plots]

Each row is one :func:`scasml_gp_torch.harness.runner.run` call, all in one
process.  SimpleScaling sweeps the full-history sample base M, so it has no
quadrature row.  The GP kernel is tuned once per (equation, dim), on the
points the harness trains on, and the winner serves every variant and
harness of that pair; only GradDependentNonlinear and SineNonlinear tune
(the semigroup surrogates of HJB and AllenCahn choose their own terminal
fit).  The tune is ``tune_gp``'s 5 ridge x 4 gamma_scale grid; ``--fit-ml``
runs the same grid and seeds the marginal-likelihood fit with its winner
(the runner's own ``--fit-ml`` seeds from a 4-candidate ridge grid).

A row that raises is recorded as ``{"error": ...}`` and the campaign goes
on.  After every row the campaign's rows are merged into
``<save-path>/run_all_summary.json``, so partial campaigns (``--equations``,
``--dims`` per call) add up to one summary.  ``--device`` defaults to cuda
and a missing CUDA device is an error; ``--no-plots`` skips the PDF figures,
which need matplotlib.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

from scasml_gp_torch.config import RunConfig
from scasml_gp_torch.gp.marginal import fit_gp_marginal_likelihood
from scasml_gp_torch.gp.tuning import tune_gp
from scasml_gp_torch.harness import runner
from scasml_gp_torch.harness.runner import GP_CLASSES, run
from scasml_gp_torch.utils.device import resolve_device

# HJB (Cole-Hopf) and AllenCahn (reaction semigroup) carry their own
# terminal-fit selection: no GPConfig tuning.
TUNABLE = ("GradDependentNonlinear", "SineNonlinear")


def campaign_rows(equations, dims, variants, harnesses):
    """(equation, dim, variant, harness) in the campaign's order."""
    return [
        (e, d, v, h)
        for e in equations
        for d in dims
        for v in variants
        for h in harnesses
        if not (h == "SimpleScaling" and v == "quadrature")
    ]


def kernel_config(config: RunConfig, device, fit_ml: bool):
    """The tuned (or, with ``fit_ml``, the grid-seeded marginal-likelihood
    fitted) GPConfig for ``config``'s equation and dim, found on the points
    the harness trains on."""
    eq, x_dom, x_bdy = runner._harness_train_points(config, device)
    gp_cls = GP_CLASSES[config.equation]
    grid = tune_gp(gp_cls, eq, x_dom, x_bdy, base=config.gp,
                   ridge_scales=runner.TUNE_RIDGE_SCALES,
                   gamma_scales=runner.TUNE_GAMMA_SCALES)
    if not fit_ml:
        return grid.config
    # the grid winner seeds the fit: unseeded, the profile-MAP descent
    # converges to over-smooth kernels at d >= 40 and the validation guard
    # has nothing better to pick (reports/ml_tuner_diagnosis.md)
    return fit_gp_marginal_likelihood(gp_cls, eq, x_dom, x_bdy, base=config.gp,
                                      seed_configs=(grid.config,)).config


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dims", type=int, nargs="+", default=[20, 40, 60, 80])
    parser.add_argument("--variants", nargs="+",
                        default=["quadrature", "full_history"],
                        choices=["quadrature", "full_history"])
    parser.add_argument("--equations", nargs="+",
                        default=["GradDependentNonlinear"],
                        help="PDE families to sweep (see "
                             "scasml_gp_torch.equations.EQUATIONS)")
    parser.add_argument("--harnesses", nargs="+", dest="harnesses", default=None,
                        help="harness classes to sweep (default: the single "
                             "--harness)")
    parser.add_argument("--harness", default="RepeatedExperiment")
    parser.add_argument("--save-path", default="results")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--num-domain", type=int, default=1000)
    parser.add_argument("--num-boundary", type=int, default=200)
    parser.add_argument("--tuned", action="store_true", default=True,
                        help="per-dimension tuned kernel (the default)")
    parser.add_argument("--no-tune", dest="tuned", action="store_false",
                        help="reference-parity hyperparameters (no tuning)")
    parser.add_argument("--fit-ml", action="store_true",
                        help="per-dimension marginal-likelihood (MAP) fit of "
                             "the kernel hyperparameters, seeded with the "
                             "tune's winner (gp/marginal.py)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; a missing "
                             "CUDA device is an error)")
    parser.add_argument("--no-plots", action="store_true",
                        help="skip the PDF figures (they need matplotlib)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    harnesses = args.harnesses or [args.harness]
    campaign = campaign_rows(args.equations, args.dims, args.variants, harnesses)
    extra = {"make_plots": False} if args.no_plots else {}
    summary = {}
    tuned_cache = {}
    for i, (equation, dim, variant, harness) in enumerate(campaign):
        tag = f"{equation}/{dim}d/{variant}/{harness}"
        print(f"[{i + 1}/{len(campaign)}] {tag}", file=sys.stderr, flush=True)
        config = RunConfig(equation=equation, dim=dim, harness=harness,
                           save_path=args.save_path, seed=args.seed,
                           num_domain=args.num_domain,
                           num_boundary=args.num_boundary)
        config = dataclasses.replace(
            config, picard=dataclasses.replace(config.picard, variant=variant))
        if (args.tuned or args.fit_ml) and equation in TUNABLE:
            if (equation, dim) not in tuned_cache:
                gp_config = kernel_config(config, device, args.fit_ml)
                print(f"  tuned: {gp_config}", file=sys.stderr, flush=True)
                tuned_cache[(equation, dim)] = gp_config
            config = dataclasses.replace(config, gp=tuned_cache[(equation, dim)])
        t0 = time.perf_counter()
        try:
            result = run(config, device=device, **extra)
            summary[tag] = {
                "wall_s": round(time.perf_counter() - t0, 2),
                "metrics": _headline(result),
            }
        except Exception as e:  # keep the campaign going past one bad run
            traceback.print_exc()
            summary[tag] = {"error": f"{type(e).__name__}: {e}"}
        print(f"  -> {summary[tag]}", file=sys.stderr, flush=True)
        _write_summary(args.save_path, summary)  # checkpoint per run

    print(json.dumps(summary, indent=2))
    print(f"written: {args.save_path}/run_all_summary.json", file=sys.stderr)
    return summary


def _write_summary(save_path, summary):
    """Merge this campaign's rows into <save_path>/run_all_summary.json: a
    later partial campaign keeps the earlier rows.  Legacy
    '<dim>d/<variant>' keys are upgraded to
    'GradDependentNonlinear/<dim>d/<variant>/RepeatedExperiment'."""
    out = f"{save_path}/run_all_summary.json"
    merged = {}
    if os.path.exists(out):
        try:
            with open(out) as fh:
                merged = json.load(fh)
        except (OSError, json.JSONDecodeError):
            merged = {}
    upgraded = {}
    for key, val in merged.items():
        if key.count("/") == 1:  # '<dim>d/<variant>' legacy row
            key = f"GradDependentNonlinear/{key}/RepeatedExperiment"
        upgraded[key] = val
    upgraded.update(summary)
    os.makedirs(save_path, exist_ok=True)
    with open(out, "w") as fh:
        json.dump(upgraded, fh, indent=2)


def _headline(result):
    """The solver-level rel-L2 headline of a harness result dict."""
    if not isinstance(result, dict):
        return result
    metrics = result.get("metrics", result)
    out = {}
    if isinstance(metrics, dict):
        # RepeatedExperiment: {metric: {solver: {mean, ...}}}
        rel = metrics.get("rel_L2")
        if isinstance(rel, dict):
            for solver, st in rel.items():
                out[solver] = st.get("mean", st) if isinstance(st, dict) else st
        else:
            # SimpleUniform: {solver: {metric: value}}
            for solver, vals in metrics.items():
                if isinstance(vals, dict) and "rel_L2" in vals:
                    out[solver] = vals["rel_L2"]
    if out:
        return {"rel_L2": out}
    return {k: result[k] for k in list(result)[:4] if not k.startswith("raw")}


if __name__ == "__main__":
    main()
