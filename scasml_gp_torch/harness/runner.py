"""Config-driven experiment runner.

Port of ``scasml_gp_tpu/harness/runner.py``, with the same flags:

    python -m scasml_gp_torch.harness.runner --dim 20 --variant full_history \
        --harness SimpleUniform --device cuda --no-plots

or programmatically via :func:`run(config, device=...)`.  A flagless run
tunes the GP kernel first (:func:`tuned_config`).  ``--device`` defaults to
cuda and a missing CUDA device is an error: the runner never moves to the CPU
by itself.  Figures need matplotlib; ``--no-plots`` skips them.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from scasml_gp_torch.config import MeshConfig, PrecisionPolicy, RunConfig
from scasml_gp_torch.equations import GradDependentNonlinear
from scasml_gp_torch.gp.solver import GPGradDependentNonlinear
from scasml_gp_torch.gp.tuning import TuneResult, tune_gp
from scasml_gp_torch.harness.repeated import RepeatedExperiment
from scasml_gp_torch.harness.simple_uniform import SimpleUniform
from scasml_gp_torch.picard.mlp import MLP, MLPFullHistory
from scasml_gp_torch.picard.scasml import ScaSML, ScaSMLFullHistory

HARNESSES = {
    "SimpleUniform": SimpleUniform,
    "RepeatedExperiment": RepeatedExperiment,
}
# The JAX package's other harnesses and equations; the CLI accepts their
# names and raises NotImplementedError for them.
UNPORTED_HARNESSES = ("ConvergenceRate", "InferenceScaling", "SimpleScaling",
                      "ComputingBudget")
UNPORTED_EQUATIONS = ("AllenCahn", "HJB", "SineNonlinear")

EQUATIONS = {"GradDependentNonlinear": GradDependentNonlinear}
GP_CLASSES = {"GradDependentNonlinear": GPGradDependentNonlinear}

# The flagless tune's grid: ridge resolves the high-d mean direction,
# gamma_scale is the big lever at low d; 5 x 4 = 20 candidates.
TUNE_RIDGE_SCALES = (0.0, 10.0, 30.0, 100.0, 300.0)
TUNE_GAMMA_SCALES = (1.0, 0.3, 0.1, 0.05)


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for but torch.cuda.is_available() is false; "
            "pass --device cpu (device='cpu') to run on the CPU"
        )
    return dev


def check_ported(config: RunConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    if config.harness in UNPORTED_HARNESSES:
        raise NotImplementedError(
            f"the {config.harness} harness is not ported (ROADMAP Queue 1 G)")
    if config.harness not in HARNESSES:
        raise ValueError(f"unknown harness {config.harness!r}")
    if config.equation in UNPORTED_EQUATIONS:
        raise NotImplementedError(
            f"the {config.equation} equation is not ported (ROADMAP Queue 1 E)")
    if config.equation not in EQUATIONS:
        raise ValueError(f"unknown equation {config.equation!r}")
    if config.mesh.data * config.mesh.model > 1 or config.mesh.data == -1:
        raise NotImplementedError(
            "a device mesh (--mesh-data/--mesh-model) is not ported "
            "(ROADMAP Queue 1 F)")
    if config.picard.debug_checks:
        raise NotImplementedError(
            "--debug-checks is not ported (ROADMAP Queue 1 J)")


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
    save_path = (
        f"{config.save_path}/{config.equation}/{config.dim}d/"
        f"{config.picard.variant}"
    )
    kwargs = dict(
        seed=config.seed,
        rhomax=config.picard.rho,
        num_domain=config.test_domain,
        num_boundary=config.test_boundary,
        train_domain=config.num_domain,
        train_boundary=config.num_boundary,
    )
    if config.picard.variant == "full_history":
        kwargs["M"] = config.picard.M
    kwargs.update(test_kwargs)
    return harness.test(save_path, **kwargs)


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


def tuned_config(config: RunConfig, device) -> "tuple[RunConfig, TuneResult]":
    """The config with the tuner's winning GP kernel, and the tuner's result.
    The tuner trains on the points the harness trains on: the same sizes,
    seed and device."""
    dev = resolve_device(device)
    check_ported(config)
    eq = EQUATIONS[config.equation](n_input=config.n_input)
    x_dom, x_bdy = eq.generate_data(
        config.num_domain, config.num_boundary,
        torch.Generator(device=dev).manual_seed(int(config.seed)), device=dev,
    )
    result = tune_gp(
        GP_CLASSES[config.equation], eq, x_dom, x_bdy, base=config.gp,
        ridge_scales=TUNE_RIDGE_SCALES, gamma_scales=TUNE_GAMMA_SCALES,
    )
    return dataclasses.replace(config, gp=result.config), result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", help="JSON RunConfig file")
    parser.add_argument("--equation", default="GradDependentNonlinear")
    parser.add_argument("--dim", type=int, default=20)
    parser.add_argument("--variant", default="quadrature",
                        choices=["quadrature", "full_history"])
    parser.add_argument("--harness", default="SimpleUniform",
                        choices=sorted(list(HARNESSES) + list(UNPORTED_HARNESSES)))
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
                        help="GP trainer: dense Newton, or auto by problem "
                             "size (the distributed trainer is not ported)")
    parser.add_argument("--rho", type=int, default=2)
    parser.add_argument("--M", type=int, default=3)
    parser.add_argument("--batch-chunk", type=int, default=None)
    parser.add_argument("--debug-checks", action="store_true",
                        help="not ported")
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
                        help="marginal-likelihood fit (not ported)")
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
        if args.fit_ml:
            raise NotImplementedError(
                "--fit-ml (gp/marginal.py) is not ported (ROADMAP Queue 1 D)")
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
        if resolve_tune(args.tune, args.ridge_scale, args.time_scale,
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
