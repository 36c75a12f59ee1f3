"""Plain reference of the GP collocation surrogate (SCaSML_GP's
``models/GP.py``): the space-time RBF kernel and its derivative blocks, the
damped-Newton train and the posterior, in plain PyTorch.

It runs in the dtype it is given: float64 for the reference, float32 with
TF32 products for the control.  The kernel is

    k(x, y) = exp(-(gs |D|^2 + gr s^2 + gt tau^2) / 2),

D = x - y over the space columns, s = sum(D), tau = x_t - y_t.  A family b
of the features phi = [ID@dom, ID@bdy, LAP@dom, DT@dom, DIV@dom] seen from
x is P_b k with a polynomial P_b in (q = |D|^2, s, tau): ID 1, LAP lapf,
DT gt tau, DIV G s.  An operator a at x applied to P k is again a
polynomial times k (``apply``), from dk/dx_i = a_i k with
a_i = -gs D_i - gr s, d/dt k = -gt tau k, and the chain rule through
dq/dx_i = 2 D_i, ds/dx_i = 1.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

FAMILIES = ("id", "id", "lap", "dt", "div")   # phi's families, in order
SETS = ("dom", "bdy", "dom", "dom", "dom")


class Pairs(NamedTuple):
    q: torch.Tensor     # (n, m) |D|^2 over the space columns
    s: torch.Tensor     # (n, m) sum of D
    tau: torch.Tensor   # (n, m) time difference
    k: torch.Tensor     # (n, m) kernel values


class Kernel(NamedTuple):
    gs: float
    gt: float
    gr: float
    d: int

    @property
    def G(self) -> float:
        return self.gs + self.d * self.gr

    @property
    def beta(self) -> float:
        return 2.0 * self.gs * self.gr + self.d * self.gr**2


def kernel_for(sigma: float, d: int, ridge_scale: float = 0.0,
               gamma_scale: float = 1.0) -> Kernel:
    """The reference's isotropic precision 1 / (sigma^2 d), with the space
    ridge ridge_scale * gs / d, all times gamma_scale."""
    gs = 1.0 / (sigma * sigma * d)
    return Kernel(gs * gamma_scale, gs * gamma_scale, ridge_scale * gs / d * gamma_scale, d)


def pairs(x: torch.Tensor, y: torch.Tensor, kern: Kernel) -> Pairs:
    xs, ys = x[:, :-1], y[:, :-1]
    q = torch.clamp_min((xs * xs).sum(1)[:, None] + (ys * ys).sum(1)[None, :]
                        - 2.0 * xs @ ys.T, 0.0)
    s = xs.sum(1)[:, None] - ys.sum(1)[None, :]
    tau = x[:, -1:] - y[:, -1][None, :]
    k = torch.exp(-0.5 * (kern.gs * q + kern.gr * s * s + kern.gt * tau * tau))
    return Pairs(q, s, tau, k)


class Poly(NamedTuple):
    """A polynomial P(q, s, tau) with the derivatives that ``apply`` needs;
    every P here is at most linear in q and tau and quadratic in s, and has
    no mixed terms in q."""

    p: torch.Tensor
    p_q: torch.Tensor
    p_s: torch.Tensor
    p_ss: torch.Tensor
    p_tau: torch.Tensor


def family(b: str, pr: Pairs, kern: Kernel) -> Poly:
    """P_b of the feature family ``b`` seen from x: the block (ID, b)."""
    one, zero = torch.ones_like(pr.q), torch.zeros_like(pr.q)
    if b == "id":
        return Poly(one, zero, zero, zero, zero)
    if b == "lap":
        lapf = kern.gs**2 * pr.q + kern.beta * pr.s**2 - kern.d * (kern.gs + kern.gr)
        return Poly(lapf, kern.gs**2 * one, 2.0 * kern.beta * pr.s,
                    2.0 * kern.beta * one, zero)
    if b == "dt":
        return Poly(kern.gt * pr.tau, zero, zero, zero, kern.gt * one)
    if b == "div":
        return Poly(kern.G * pr.s, zero, kern.G * one, zero, zero)
    raise ValueError(b)


def apply(a: str, P: Poly, pr: Pairs, kern: Kernel) -> torch.Tensor:
    """(operator a at x)(P k), as a matrix: a in id, dt, div (sum of the
    space derivatives), lap (space Laplacian)."""
    gs, gr, d = kern.gs, kern.gr, kern.d
    if a == "id":
        return P.p * pr.k
    if a == "dt":
        return (P.p_tau - kern.gt * pr.tau * P.p) * pr.k
    if a == "div":
        # sum_i [(2 P_q - gs P) D_i + (P_s - gr s P)]
        return ((2.0 * P.p_q - gs * P.p) * pr.s + d * (P.p_s - gr * pr.s * P.p)) * pr.k
    if a == "lap":
        lap_p = 2.0 * d * P.p_q + d * P.p_ss
        grad_p_dot_a = (-2.0 * gs * P.p_q * pr.q - 2.0 * gr * P.p_q * pr.s**2
                        - (gs + d * gr) * pr.s * P.p_s)
        lapf = gs**2 * pr.q + kern.beta * pr.s**2 - d * (gs + gr)
        return (lap_p + 2.0 * grad_p_dot_a + P.p * lapf) * pr.k
    raise ValueError(a)


def gram(x_dom, x_bdy, kern: Kernel) -> torch.Tensor:
    """The phi x phi Gram, phi = 4N + Nb."""
    pts = {"dom": x_dom, "bdy": x_bdy}
    prs = {(a, b): pairs(pts[a], pts[b], kern) for a in pts for b in pts}
    return torch.cat([
        torch.cat([apply(a, family(b, prs[sa, sb], kern), prs[sa, sb], kern)
                   for b, sb in zip(FAMILIES, SETS)], dim=1)
        for a, sa in zip(FAMILIES, SETS)], dim=0)


class Trained(NamedTuple):
    x_dom: torch.Tensor
    x_bdy: torch.Tensor
    kern: Kernel
    weights: torch.Tensor        # (phi,) C b(sol)
    sol: torch.Tensor            # (3N,) (z1, z3, z5)
    losses: torch.Tensor         # (steps + 1,) the loss after each step


class Problem(NamedTuple):
    """The train's fixed parts: C = (K + nugget I)^{-1} and b(sol)."""

    x_dom: torch.Tensor
    x_bdy: torch.Tensor
    kern: Kernel
    C: torch.Tensor
    g_bdy: torch.Tensor
    sigma: float

    def b(self, sol):
        """b(sol) = [z1, g_bdy, z3, F(z1, z3, z5), z5], for the
        gradient-dependent equation F = -sigma^2 z1 z5 + (1/d + sigma^2/2) z5
        - (sigma^2/2) z3; sol (..., 3N) -> (..., phi)."""
        N, Nb = self.x_dom.shape[0], self.x_bdy.shape[0]
        sig2 = self.sigma**2
        z1, z3, z5 = sol[..., :N], sol[..., N:2 * N], sol[..., 2 * N:]
        F = -sig2 * z1 * z5 + (1.0 / self.kern.d + sig2 / 2.0) * z5 - 0.5 * sig2 * z3
        return torch.cat([z1, self.g_bdy.expand(sol.shape[:-1] + (Nb,)), z3, F, z5], dim=-1)

    def loss(self, sols):
        """b^T C b of each row of sols (k, 3N)."""
        B = self.b(sols)
        return ((B @ self.C) * B).sum(-1)

    def trained(self, sol, losses) -> Trained:
        return Trained(self.x_dom, self.x_bdy, self.kern, self.C @ self.b(sol), sol, losses)


def problem(x_dom, x_bdy, kern: Kernel, g_bdy, sigma: float, nugget: float) -> Problem:
    """The Gram of the points and its regularized inverse, in the dtype of
    the points."""
    K = gram(x_dom, x_bdy, kern)
    K = 0.5 * (K + K.T) + nugget * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    # Jacobi scaling keeps the inverse accurate; (D M D)^{-1} = D^-1 M^-1 D^-1
    scale = torch.rsqrt(torch.diagonal(K))
    C = scale[:, None] * torch.linalg.inv(scale[:, None] * K * scale[None, :]) * scale[None, :]
    return Problem(x_dom, x_bdy, kern, C, g_bdy, sigma)


def train(pb: Problem, steps: int, sol0, damping: float = 1e-4,
          grad_tol: float = 1e-5) -> Trained:
    """Damped Newton on loss(sol) = b^T C b from sol0: the analytic gradient
    and Hessian, the 8 step lengths 2^-j, and the damping cut tenfold after
    a step that lowers the loss and raised tenfold after one that does not
    (SCaSML_GP's ``models/GP.py``)."""
    N, Nb = pb.x_dom.shape[0], pb.x_bdy.shape[0]
    dt, dev = pb.C.dtype, pb.C.device
    sig2 = pb.sigma**2
    i3, i4 = 2 * N + Nb, 3 * N + Nb
    eye = torch.eye(N, dtype=dt, device=dev)

    def jac(sol):                          # db/dsol, (phi, 3N)
        z1, z5 = sol[:N], sol[2 * N:]
        J = torch.zeros((4 * N + Nb, 3 * N), dtype=dt, device=dev)
        J[:N, :N] = eye
        J[N + Nb:2 * N + Nb, N:2 * N] = eye
        J[i4:, 2 * N:] = eye
        J[i3:i4, :N] = torch.diag(-sig2 * z5)
        J[i3:i4, N:2 * N] = -0.5 * sig2 * eye
        J[i3:i4, 2 * N:] = torch.diag(-sig2 * z1 + 1.0 / pb.kern.d + sig2 / 2.0)
        return J

    sol = sol0.to(dt)
    J_loss = pb.loss(sol[None])[0]
    losses = [J_loss]
    alphas = 0.5 ** torch.arange(8, dtype=dt, device=dev)
    damp, done = damping, False
    eye3 = torch.eye(3 * N, dtype=dt, device=dev)
    idx = torch.arange(N, device=dev)
    for _ in range(steps):
        Cb = pb.C @ pb.b(sol)
        Jm = jac(sol)
        grad = 2.0 * Jm.T @ Cb
        stop = done or bool(torch.linalg.vector_norm(grad) < grad_tol)
        H = 2.0 * Jm.T @ pb.C @ Jm
        # F's second derivative: d2F/dz1 dz5 = -sigma^2, weighted by (Cb)_F
        w = -sig2 * 2.0 * Cb[i3:i4]
        H[idx, 2 * N + idx] += w
        H[2 * N + idx, idx] += w
        step = torch.linalg.solve(H + damp * eye3, -grad)
        cand = sol[None] + alphas[:, None] * step[None]
        cl = pb.loss(cand)
        best = int(torch.argmin(cl))
        improved = bool(cl[best] < J_loss)
        if improved and not stop:
            sol, J_loss = cand[best], cl[best]
        damp = max(damp * 0.1, damping) if improved else min(damp * 10.0, 1.0)
        losses.append(J_loss)
        done = stop
    return pb.trained(sol, torch.stack(losses))


class Posterior(NamedTuple):
    u: torch.Tensor           # (n,)
    grad: torch.Tensor        # (n, d) space gradient, or None
    dt: torch.Tensor          # (n,) or None
    div: torch.Tensor
    lap: torch.Tensor


def posterior(tr: Trained, x, want_grad=False, want_ops=False,
              block: int = 4096) -> Posterior:
    """u(x) = sum over phi of (ID at x, family at y) w, with the space
    gradient and dt, div, lap of u where asked, in blocks of rows."""
    parts = [_posterior_block(tr, x[i:i + block], want_grad, want_ops)
             for i in range(0, x.shape[0], block)]
    return Posterior(*(None if p[0] is None else torch.cat(p) for p in zip(*parts)))


def _posterior_block(tr: Trained, x, want_grad, want_ops) -> Posterior:
    kern = tr.kern
    N, Nb = tr.x_dom.shape[0], tr.x_bdy.shape[0]
    w = tr.weights
    w_dom = {"id": w[:N], "lap": w[N + Nb:2 * N + Nb], "dt": w[2 * N + Nb:3 * N + Nb],
             "div": w[3 * N + Nb:]}
    out: Dict[str, torch.Tensor] = {}
    for pts, weights in ((tr.x_dom, w_dom), (tr.x_bdy, {"id": w[N:N + Nb]})):
        pr = pairs(x, pts, kern)
        # P = sum_b w_b P_b, with its derivatives, per pair
        polys = [family(b, pr, kern) for b in weights]
        P = Poly(*(sum(getattr(pb, f) * wb[None, :] for pb, wb in zip(polys, weights.values()))
                   for f in Poly._fields))
        terms = {"u": apply("id", P, pr, kern).sum(1)}
        if want_grad:
            # d/dx_i (P k) = k [(2 P_q - gs P) D_i + (P_s - gr s P)]
            c1 = (2.0 * P.p_q - kern.gs * P.p) * pr.k
            c2 = (P.p_s - kern.gr * pr.s * P.p) * pr.k
            terms["grad"] = (x[:, :-1] * c1.sum(1)[:, None] - c1 @ pts[:, :-1]
                             + c2.sum(1)[:, None])
        if want_ops:
            for a in ("dt", "div", "lap"):
                terms[a] = apply(a, P, pr, kern).sum(1)
        for key, val in terms.items():
            out[key] = out[key] + val if key in out else val
    return Posterior(out["u"], out.get("grad"), out.get("dt"), out.get("div"), out.get("lap"))
