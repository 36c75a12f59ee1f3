"""The program's side and the reference's side of the check: the port's
GP for a configuration, the reference trained on the same inputs, the
reference's answer to a served request, and the gap between the two."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import gp as rgp
from benchmark.reference import picard as rpicard

SOLVE_SEED = 0


def port_gp(config: dict, device, ridge_scale: float = 0.0, gamma_scale: float = 1.0):
    """(equation, GP) of the port for the configuration and a kernel."""
    from scasml_gp_torch import EQUATIONS, GPConfig, GPGradDependentNonlinear

    if config["equation"] != "GradDependentNonlinear":
        raise ValueError(f"the reference has no {config['equation']}")
    eq = EQUATIONS[config["equation"]](n_input=int(config["dim"]) + 1)
    gp = GPGradDependentNonlinear(
        eq, GPConfig(nugget=float(config["nugget"]), gn_steps=int(config["gn_steps"]),
                     ridge_scale=ridge_scale, gamma_scale=gamma_scale), device=device)
    return eq, gp


def gap(prog, ref) -> float:
    """max |prog - ref| / rms(ref) over the rows compared."""
    prog = np.asarray(prog, np.float64).reshape(-1)
    ref = np.asarray(ref, np.float64).reshape(-1)
    return float(np.max(np.abs(prog - ref)) / np.sqrt(np.mean(ref * ref)))


def reference_problem(config: dict, x_dom, x_bdy, dtype=torch.float64,
                      ridge_scale: float = 0.0, gamma_scale: float = 1.0) -> rgp.Problem:
    """The reference's Gram inverse and b on the same points."""
    xd, xb = x_dom.to(dtype), x_bdy.to(dtype)
    g_bdy = torch.sigmoid(xb[:, -1] + xb[:, :-1].sum(1))
    kern = rgp.kernel_for(rpicard.SIGMA, int(config["dim"]), ridge_scale, gamma_scale)
    return rgp.problem(xd, xb, kern, g_bdy, rpicard.SIGMA, float(config["nugget"]))


def initial_point(x_dom) -> torch.Tensor:
    """The Newton train's initial point: a generator on the points' device
    seeded with 0, times 1e-3."""
    dev = x_dom.device
    gen = torch.Generator(device=dev).manual_seed(0)
    return torch.randn((3 * x_dom.shape[0],), generator=gen, device=dev) * 1e-3


def reference_train(config: dict, x_dom, x_bdy, dtype=torch.float64,
                    ridge_scale: float = 0.0, gamma_scale: float = 1.0) -> rgp.Trained:
    """The reference GP on the same points, from the same initial point."""
    pb = reference_problem(config, x_dom, x_bdy, dtype, ridge_scale, gamma_scale)
    return rgp.train(pb, int(config["gn_steps"]), initial_point(x_dom))


def train_numbers(pb: rgp.Problem, ref: rgp.Trained, u, sol):
    """(state gap, loss excess) of one train against the float64 reference:
    the train's answer u at the interior points against the reference's
    posterior from the train's own final unknowns ``sol`` (weights
    C b(sol)); and the objective b^T C b at ``sol``, in float64, over the
    reference train's own final objective, less 1."""
    sol = torch.as_tensor(sol, dtype=pb.C.dtype, device=pb.C.device)
    own = pb.trained(sol, ref.losses)
    state = gap(u, rgp.posterior(own, own.x_dom).u.cpu().numpy())
    excess = float(pb.loss(sol[None])[0] / pb.loss(ref.sol[None])[0]) - 1.0
    return state, excess


def reference_answer(config: dict, trained: rgp.Trained, endpoint: str, x: np.ndarray,
                     buckets) -> np.ndarray:
    """The reference's answer to one request, as the server defines it."""
    dev, dt = trained.x_dom.device, trained.x_dom.dtype
    xt = torch.as_tensor(x, device=dev)
    if endpoint == "predict":
        return rgp.posterior(trained, xt.to(dt)).u.cpu().numpy()
    real = x.shape[0]
    bucket = next(b for b in buckets if b >= real)
    padded = torch.cat([xt, xt[-1:].expand(bucket - real, -1)]).to(dt)
    gen = torch.Generator(device=dev).manual_seed(SOLVE_SEED)
    u = rpicard.solve(rpicard.Problem(trained), padded, gen, config["solver"],
                      int(config["n"]), rho=int(config.get("rho") or 2),
                      M=int(config.get("M") or 3))
    return u[:real].cpu().numpy()
