"""Plain reference of the ScaSML solve: the multilevel Picard recursion on
the residual of a trained GP surrogate (SCaSML_GP's ``solvers``), in plain
PyTorch, over ``gp.py``'s posterior.

For the gradient-dependent equation (sigma = 0.25, mu = -1/d - sigma^2/2,
f(x, u, z) = sigma u sum(z), g = sigmoid(t + sum x)) the recursion runs on
u_breve = u - u_hat:

    f_breve(x, ub, zb) = f(x, ub + u_hat, sigma grad u_hat + zb) - f(x, u_hat, sigma grad u_hat)
    g_breve(x)         = g(x) - u_hat(x)
    leaf               = the PDE residual of u_hat,

and u = u_hat + clip(u_breve, 0.1).  The quadrature variant integrates the
f terms over time with Gauss-Legendre rules; the full-history variant
samples the times.  Every random number is drawn from the generator it is
given, in the recursion's order (depth first: a node's terminal draws, then
per level and time point its path increments, then its children), in
float32, whatever the dtype of the arithmetic.
"""

from __future__ import annotations

import torch

from benchmark.reference import gp as rgp
from benchmark.work import quadrature_tables

SIGMA = 0.25
CLIP = 0.1


class Problem:
    """The gradient-dependent equation on a trained reference GP."""

    def __init__(self, trained: rgp.Trained, T: float = 0.5):
        self.tr = trained
        self.d = trained.kern.d
        self.T = T
        self.mu = -1.0 / self.d - SIGMA**2 / 2.0

    def g(self, x):
        return torch.sigmoid(x[:, -1] + x[:, :-1].sum(1))[:, None]

    def f(self, u, z):
        return SIGMA * u * z.sum(1, keepdim=True)

    def g_breve(self, x):
        return self.g(x) - rgp.posterior(self.tr, x).u[:, None]

    def f_breve(self, x, ub, zb):
        post = rgp.posterior(self.tr, x, want_grad=True)
        u_hat, z_hat = post.u[:, None], SIGMA * post.grad
        return self.f(ub + u_hat, z_hat + zb) - self.f(u_hat, z_hat)

    def leaf(self, x):
        p = rgp.posterior(self.tr, x, want_ops=True)
        sig2 = SIGMA**2
        return (p.dt + (sig2 * p.u - 1.0 / self.d - sig2 / 2.0) * p.div
                + (sig2 / 2.0) * p.lap)[:, None]


def _normal(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).to(dtype)


def _terminal(pb: Problem, x, t, gen, mc: int):
    """u = mean g_breve(X_T), z = mean(g_breve(X_T) xi) / (T - t + 1e-6)."""
    B, d = x.shape
    dT = (pb.T - t)[:, None]
    xi = _normal(gen, (B, mc, d), x.dtype)
    XT = x[:, None, :] + pb.mu * dT[..., None] + SIGMA * torch.sqrt(dT)[..., None] * xi
    pts = torch.cat([XT, torch.full((B, mc, 1), pb.T, dtype=x.dtype, device=x.device)], 2)
    gv = pb.g_breve(pts.reshape(-1, d + 1)).reshape(B, mc)
    return gv.mean(1, keepdim=True), (gv[..., None] * xi).sum(1) / (mc * (dT + 1e-6))


def quadrature(pb: Problem, x_t, gen, n: int, rho: int):
    """(B, 1 + d) [u_breve, z_breve] of the quadrature recursion (n, rho)."""
    Mf, Mg, Q, rules = quadrature_tables(rho, pb.T)

    def uz(lvl, x_t):
        B, dt = x_t.shape[0], x_t.dtype
        if lvl <= 0:
            return torch.zeros((B, 1 + pb.d), dtype=dt, device=x_t.device)
        x, t = x_t[:, :-1], x_t[:, -1]
        u, z = _terminal(pb, x, t, gen, int(Mg[rho - 1, lvl]))
        for l in range(lvl):
            q, mf = int(Q[rho - 1, lvl - l - 1]), int(Mf[rho - 1, lvl - l - 1])
            nodes, weights = (torch.as_tensor(a, dtype=dt, device=x_t.device) for a in rules[q])
            c = t[:, None] + (pb.T - t)[:, None] * nodes[None, :] / pb.T
            wq = (pb.T - t)[:, None] * weights[None, :] / pb.T
            steps = torch.diff(torch.cat([t[:, None], c], 1), dim=1)
            X = x[:, None, :].expand(B, mf, pb.d)
            W = torch.zeros_like(X)
            for k in range(q):
                dW = torch.sqrt(steps[:, k])[:, None, None] * _normal(gen, (B, mf, pb.d), dt)
                W = W + dW
                X = X + pb.mu * steps[:, k, None, None] + SIGMA * dW
                pts = torch.cat([X, c[:, k, None, None].expand(B, mf, 1)], 2).reshape(-1, pb.d + 1)
                wk, denom = wq[:, k, None], (c[:, k] - t + 1e-6)[:, None]
                terms = []
                if l > 0:
                    terms.append((1.0, uz(l, pts)))
                if l > 1:
                    terms.append((-1.0, uz(l - 1, pts)))
                for sign, sim in terms:
                    y = pb.f_breve(pts, sim[:, :1], sim[:, 1:]).reshape(B, mf)
                    u = u + sign * wk * y.mean(1, keepdim=True)
                    z = z + sign * wk * (y[..., None] * W).sum(1) / (mf * denom)
                if l == 0:
                    eps = pb.leaf(pts).reshape(B, mf)
                    u = u + wk * eps.mean(1, keepdim=True)
                    z = z + wk * (eps[..., None] * W).sum(1) / (mf * denom)
        return torch.clamp(torch.cat([u, z], 1), -CLIP, CLIP)

    return uz(n, x_t)


def full_history(pb: Problem, x_t, gen, n: int, M: int):
    """(B, 1 + d) [u_breve, z_breve] of the full-history recursion (n, M),
    with uniform interior times."""

    def uz(lvl, x_t):
        B, dt = x_t.shape[0], x_t.dtype
        if lvl <= 0:
            return torch.zeros((B, 1 + pb.d), dtype=dt, device=x_t.device)
        x, t = x_t[:, :-1], x_t[:, -1]
        dT = (pb.T - t)[:, None]
        u, z = _terminal(pb, x, t, gen, M**lvl)
        for l in range(lvl):
            mf = M ** (lvl - l)
            tau = torch.rand((B, mf), generator=gen, device=gen.device,
                             dtype=torch.float32).to(dt)
            ts = (tau * dT)[..., None]
            xi = _normal(gen, (B, mf, pb.d), dt)
            X = x[:, None, :] + pb.mu * ts + SIGMA * torch.sqrt(ts) * xi
            pts = torch.cat([X, t[:, None, None] + ts], 2).reshape(-1, pb.d + 1)
            eta = xi / torch.sqrt(ts + 1e-6)
            terms = []
            if l > 0:
                terms.append((1.0, uz(l, pts)))
            if l > 1:
                terms.append((-1.0, uz(l - 1, pts)))
            for sign, sim in terms:
                y = pb.f_breve(pts, sim[:, :1], sim[:, 1:]).reshape(B, mf)
                u = u + sign * dT * y.mean(1, keepdim=True)
                z = z + sign * dT * (y[..., None] * eta).sum(1) / mf
            if l == 0:
                eps = pb.leaf(pts).reshape(B, mf)
                u = u + dT * eps.mean(1, keepdim=True)
                z = z + dT * (eps[..., None] * eta).sum(1) / mf
        return torch.clamp(torch.cat([u, z], 1), -CLIP, CLIP)

    return uz(n, x_t)


def solve(pb: Problem, x_t, gen, solver: str, n: int, rho: int = 2, M: int = 3):
    """u = u_hat + u_breve at x_t (B, d + 1), shape (B,)."""
    if solver == "quadrature":
        out = quadrature(pb, x_t, gen, n, rho)
    else:
        out = full_history(pb, x_t, gen, n, M)
    return rgp.posterior(pb.tr, x_t).u + out[:, 0]
