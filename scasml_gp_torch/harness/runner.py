"""Config-driven experiment runner.

Port of ``scasml_gp_tpu/harness/runner.py``, with the same flags:

    python -m scasml_gp_torch.harness.runner --dim 20 --variant full_history \
        --harness SimpleUniform --device cuda --no-plots

or programmatically via :func:`run(config, device=...)`.  A flagless run
tunes the GP kernel first (:func:`tuned_config`); ``--fit-ml`` fits it by
marginal likelihood instead (:func:`fitted_config`).  ``--device`` defaults to
cuda and a missing CUDA device is an error: the runner never moves to the CPU
by itself.  Figures need matplotlib; ``--no-plots`` skips them.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from scasml_gp_torch.config import MeshConfig, PrecisionPolicy, RunConfig
from scasml_gp_torch.equations import EQUATIONS
from scasml_gp_torch.gp.cole_hopf import GPHJBColeHopf
from scasml_gp_torch.gp.semigroup import GPAllenCahnSemigroup
from scasml_gp_torch.gp.solver import GPGradDependentNonlinear, GPSineNonlinear
from scasml_gp_torch.gp.marginal import MarginalFitResult, fit_gp_marginal_likelihood
from scasml_gp_torch.gp.tuning import TuneResult, tune_gp
from scasml_gp_torch.harness.computing_budget import ComputingBudget
from scasml_gp_torch.harness.convergence_rate import ConvergenceRate
from scasml_gp_torch.harness.inference_scaling import InferenceScaling
from scasml_gp_torch.harness.repeated import RepeatedExperiment
from scasml_gp_torch.harness.simple_scaling import SimpleScaling
from scasml_gp_torch.harness.simple_uniform import SimpleUniform
from scasml_gp_torch.picard.mlp import MLP, MLPFullHistory
from scasml_gp_torch.picard.scasml import ScaSML, ScaSMLFullHistory
from scasml_gp_torch.utils.device import resolve_device

HARNESSES = {
    "SimpleUniform": SimpleUniform,
    "RepeatedExperiment": RepeatedExperiment,
    "ConvergenceRate": ConvergenceRate,
    "InferenceScaling": InferenceScaling,
    "SimpleScaling": SimpleScaling,
    "ComputingBudget": ComputingBudget,
}

GP_CLASSES = {
    "GradDependentNonlinear": GPGradDependentNonlinear,
    # the semigroup surrogates: space-time collocation is ill-posed for
    # these terminal-value problems (gp/cole_hopf.py, gp/semigroup.py)
    "AllenCahn": GPAllenCahnSemigroup,
    "HJB": GPHJBColeHopf,
    "SineNonlinear": GPSineNonlinear,
}

# The flagless tune's grid: ridge resolves the high-d mean direction,
# gamma_scale is the big lever at low d; 5 x 4 = 20 candidates.
TUNE_RIDGE_SCALES = (0.0, 10.0, 30.0, 100.0, 300.0)
TUNE_GAMMA_SCALES = (1.0, 0.3, 0.1, 0.05)
# --fit-ml seeds its restarts from this smaller grid's winner.
FIT_ML_RIDGE_SCALES = (0.0, 10.0, 30.0, 100.0)


def check_ported(config: RunConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    if config.harness not in HARNESSES:
        raise ValueError(f"unknown harness {config.harness!r}")
    if config.equation not in EQUATIONS:
        raise ValueError(f"unknown equation {config.equation!r}")
    if config.mesh.data * config.mesh.model > 1 or config.mesh.data == -1:
        raise NotImplementedError(
            "a device mesh (--mesh-data/--mesh-model) is not ported "
            "(ROADMAP Queue 1 F2)")


def build_solvers(config: RunConfig, device):
    """(equation, gp, mlp, scasml) per the config's PDE/dim/variant, on
    ``device``."""
    check_ported(config)
    eq = EQUATIONS[config.equation](n_input=config.n_input)
    gp = GP_CLASSES[config.equation](
        eq, config.gp, precision=config.precision, device=device
    )
    kw = dict(batch_chunk=config.picard.batch_chunk, precision=config.precision,
              mesh=None, debug_checks=config.picard.debug_checks)
    if config.picard.variant == "full_history":
        mlp = MLPFullHistory(eq, device=device, **kw)
        scasml = ScaSMLFullHistory(eq, gp, **kw)
    else:
        mlp = MLP(eq, device=device, **kw)
        scasml = ScaSML(eq, gp, **kw)
    return eq, gp, mlp, scasml


def run(config: RunConfig, device="cuda", **test_kwargs):
    """Build solvers + harness from the config on ``device`` and execute one
    run; returns the harness's result (the contents of metrics.json)."""
    dev = resolve_device(device)
    eq, gp, mlp, scasml = build_solvers(config, dev)
    harness = HARNESSES[config.harness](eq, gp, mlp, scasml, wandb=config.wandb)
    return harness.test(run_dir(config), **harness_kwargs(config, **test_kwargs))


def run_dir(config: RunConfig) -> str:
    """<save_path>/<equation>/<dim>d/<variant>; the harness adds its name."""
    return (f"{config.save_path}/{config.equation}/{config.dim}d/"
            f"{config.picard.variant}")


def harness_kwargs(config: RunConfig, **test_kwargs) -> dict:
    """The keyword arguments ``run`` passes to the harness's ``test``, as
    the JAX runner selects them: the sizes and the depth go to SimpleUniform
    and RepeatedExperiment only, and M to every full-history harness but
    SimpleScaling (the sweeps forward unknown keywords into ``u_solve``).
    The sweeps otherwise run at their own defaults."""
    kwargs = dict(seed=config.seed)
    if config.harness in ("SimpleUniform", "RepeatedExperiment"):
        kwargs.update(
            rhomax=config.picard.rho,
            num_domain=config.test_domain,
            num_boundary=config.test_boundary,
            train_domain=config.num_domain,
            train_boundary=config.num_boundary,
        )
    if config.picard.variant == "full_history" and config.harness != "SimpleScaling":
        kwargs["M"] = config.picard.M
    kwargs.update(test_kwargs)
    return kwargs


def resolve_tune(tune_flag, ridge_scale, time_scale, fit_ml, equation):
    """Auto-tune policy for the CLI: flagless runs tune.  An explicit kernel
    flag (--ridge-scale/--time-scale), --no-tune, --fit-ml, or an equation
    without a GPConfig-driven surrogate opts out."""
    if tune_flag is not None:
        return tune_flag
    explicit_kernel = ridge_scale != 0.0 or time_scale != 1.0
    return (
        not explicit_kernel
        and not fit_ml
        and equation in ("GradDependentNonlinear", "SineNonlinear")
    )


def _harness_train_points(config: RunConfig, device):
    """(equation, x_dom, x_bdy): the points the harness trains on, with the
    same sizes, seed and device."""
    dev = resolve_device(device)
    check_ported(config)
    eq = EQUATIONS[config.equation](n_input=config.n_input)
    x_dom, x_bdy = eq.generate_data(
        config.num_domain, config.num_boundary,
        torch.Generator(device=dev).manual_seed(int(config.seed)), device=dev,
    )
    return eq, x_dom, x_bdy


def tuned_config(config: RunConfig, device) -> "tuple[RunConfig, TuneResult]":
    """The config with the tuner's winning GP kernel, and the tuner's result.
    The tuner trains on the points the harness trains on."""
    eq, x_dom, x_bdy = _harness_train_points(config, device)
    result = tune_gp(
        GP_CLASSES[config.equation], eq, x_dom, x_bdy, base=config.gp,
        ridge_scales=TUNE_RIDGE_SCALES, gamma_scales=TUNE_GAMMA_SCALES,
    )
    return dataclasses.replace(config, gp=result.config), result


def fitted_config(config: RunConfig, device
                  ) -> "tuple[RunConfig, MarginalFitResult]":
    """--fit-ml: the config with the marginal-likelihood fit's GP kernel, and
    the fit's result.  A 4-candidate ridge grid runs first and its winner
    seeds the fit and competes in its candidate table, so the shipped kernel
    never scores worse than the grid's.  Both train on the points the
    harness trains on."""
    eq, x_dom, x_bdy = _harness_train_points(config, device)
    if config.dim > 20:
        print("warning: --fit-ml at d > 20 is a grid-seeded REFINER, not a "
              "standalone fitter — the profile-MAP NLML descent converges to "
              "over-smooth kernels at high d and the validation guard falls "
              "back to the grid winner (measured attribution: "
              "reports/ml_tuner_diagnosis.md)", file=sys.stderr)
    gp_cls = GP_CLASSES[config.equation]
    grid = tune_gp(gp_cls, eq, x_dom, x_bdy, base=config.gp,
                   ridge_scales=FIT_ML_RIDGE_SCALES)
    result = fit_gp_marginal_likelihood(gp_cls, eq, x_dom, x_bdy, base=config.gp,
                                        seed_configs=(grid.config,))
    return dataclasses.replace(config, gp=result.config), result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", help="JSON RunConfig file")
    parser.add_argument("--equation", default="GradDependentNonlinear")
    parser.add_argument("--dim", type=int, default=20)
    parser.add_argument("--variant", default="quadrature",
                        choices=["quadrature", "full_history"])
    parser.add_argument("--harness", default="SimpleUniform",
                        choices=sorted(HARNESSES))
    parser.add_argument("--save-path", default="results")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--num-domain", type=int, default=1000,
                        help="GP training interior points")
    parser.add_argument("--num-boundary", type=int, default=200,
                        help="GP training boundary points")
    parser.add_argument("--test-domain", type=int, default=1000)
    parser.add_argument("--test-boundary", type=int, default=200)
    parser.add_argument("--train-backend", default="auto",
                        choices=["auto", "dense", "distributed"],
                        help="GP trainer: dense Newton, the dual-CG trainer "
                             "(gp/distributed.py), or auto by problem size "
                             "(distributed past phi = 4N + Nb > 8400)")
    parser.add_argument("--rho", type=int, default=2)
    parser.add_argument("--M", type=int, default=3)
    parser.add_argument("--batch-chunk", type=int, default=None)
    parser.add_argument("--debug-checks", action="store_true",
                        help="check every op of the Picard rollouts for NaN and "
                             "raise at the first (one host sync per op)")
    parser.add_argument("--mesh-data", type=int, default=1,
                        help="devices on the 'data' mesh axis; only 1 is ported")
    parser.add_argument("--mesh-model", type=int, default=1,
                        help="devices on the 'model' mesh axis; only 1 is ported")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 precision policy (its bf16 Gram is not "
                             "ported)")
    parser.add_argument("--wandb", action="store_true",
                        help="stream metrics to wandb (no-op if unavailable)")
    parser.add_argument("--profile-dir", default=None,
                        help="dump a cProfile .prof + torch.profiler trace of "
                             "the solve phase into this directory")
    parser.add_argument("--ridge-scale", type=float, default=0.0,
                        help="ridge kernel precision multiplier (0 = reference kernel)")
    parser.add_argument("--time-scale", type=float, default=1.0)
    parser.add_argument("--tune", dest="tune", action="store_true",
                        default=None,
                        help="select (ridge_scale, gamma_scale) by the ScaSML "
                             "judge before the run; the default for the "
                             "standard GP equations unless --no-tune or an "
                             "explicit --ridge-scale/--time-scale is given")
    parser.add_argument("--no-tune", dest="tune", action="store_false",
                        help="disable the default hyperparameter tuning")
    parser.add_argument("--fit-ml", action="store_true",
                        help="fit (gamma_scale, time_scale, ridge_scale) by "
                             "marginal-likelihood descent, seeded from a "
                             "ridge grid, before the run (gp/marginal.py)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; a missing "
                             "CUDA device is an error)")
    parser.add_argument("--no-plots", action="store_true",
                        help="skip the PDF figures (they need matplotlib)")
    args = parser.parse_args(argv)

    if args.config:
        if args.tune or args.fit_ml:
            parser.error("--tune/--fit-ml are CLI-path options; with "
                         "--config, set the GP hyperparameters in the JSON")
        with open(args.config) as fh:
            config = RunConfig.from_json(fh.read())
    else:
        config = RunConfig(
            equation=args.equation,
            dim=args.dim,
            harness=args.harness,
            save_path=args.save_path,
            seed=args.seed,
            wandb=args.wandb,
            num_domain=args.num_domain,
            num_boundary=args.num_boundary,
            test_domain=args.test_domain,
            test_boundary=args.test_boundary,
        )
        config = dataclasses.replace(
            config,
            gp=dataclasses.replace(
                config.gp, ridge_scale=args.ridge_scale,
                time_scale=args.time_scale,
                train_backend=args.train_backend,
            ),
            picard=dataclasses.replace(
                config.picard, variant=args.variant, rho=args.rho, M=args.M,
                batch_chunk=args.batch_chunk,
                debug_checks=args.debug_checks,
            ),
            mesh=MeshConfig(data=args.mesh_data, model=args.mesh_model),
            precision=(
                PrecisionPolicy(gram="bfloat16", rollout="bfloat16")
                if args.bf16 else PrecisionPolicy()
            ),
        )
        check_ported(config)
        if args.fit_ml:
            config, fit = fitted_config(config, args.device)
            print(f"ML-fitted GP config: {config.gp} (NLML {fit.nlml:.1f}; grid "
                  f"seed {fit.table[1][0].ridge_scale})", file=sys.stderr)
        elif resolve_tune(args.tune, args.ridge_scale, args.time_scale,
                          args.fit_ml, config.equation):
            config, _ = tuned_config(config, args.device)
            print(f"tuned GP config: {config.gp}", file=sys.stderr)
    extra = {"profile_dir": args.profile_dir} if args.profile_dir else {}
    if args.no_plots:
        extra["make_plots"] = False
    result = run(config, device=args.device, **extra)
    print("done:", config.harness, file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
