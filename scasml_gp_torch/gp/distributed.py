"""The large-N GP trainer: matrix-free Gauss-Newton on the dual system.

Port of ``scasml_gp_tpu/gp/distributed.py`` on one device.  The dense
trainer (gp/solver.py) forms C = (K + nugget I)^{-1}, an O(phi^3) object; here
the only O(phi^2) object is the Gram K itself, and every solve is a
preconditioned conjugate gradient whose matvec is one GEMV with K.

Each Gauss-Newton step minimises the linearised objective

    min_b  b^T Ktil^{-1} b   s.t.  M b = m,     Ktil = K + nugget I,

where the (N + Nb) x phi constraint matrix M pins the boundary rows
(b_R2 = g) and the linearised F rows (b_R4 - f1 b_R1 - f3 b_R3 - f5 b_R5 =
c_lin, with (f1, f3, f5) = diag dF at the current iterate).  By duality
b* = Ktil M^T mu with (M Ktil M^T) mu = m: one CG of size N + Nb whose
matvec is mu -> M(Ktil(M^T mu)).  The step's loss b*^T Ktil^{-1} b* is
m^T mu.  A last CG on Ktil gives the representer weights of the final
iterate.  The Jacobi preconditioners come from the closed-form diagonals of
the self-pair kernel blocks.

Without a mesh K stays whole on the device (4.4 GB in float32 at phi =
33 280).  With a mesh of more than one 'model' rank each rank holds its block
of K's rows (parallel/mesh.py); a matvec is a local ``torch.mv`` and one
all-gather of the length-phi result over the 'model' axis.  The gathered
vector is bitwise the same on every rank, and so is every scalar of the CG
recurrence, so the ranks take the same stop decisions and issue the same
collectives.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from scasml_gp_torch.gp.gram import gram_matrix, gram_rows
from scasml_gp_torch.gp.kernels import PairStats, op_block
from scasml_gp_torch.gp.state import GPState

# Iterations of pcg between two host checks of its stopping rule.
CHECK_EVERY = 8


class DistTrainOut(NamedTuple):
    sol: torch.Tensor             # (3N,) trained (z1, z3, z5)
    right_vector: torch.Tensor    # (phi,) representer weights Ktil^{-1} b(sol)
    loss_history: torch.Tensor    # (gn_steps,) m^T mu per Gauss-Newton step
    final_residual: torch.Tensor  # ||Ktil w - b(sol)|| / ||b(sol)|| of the last CG
    cg_iterations: torch.Tensor   # (gn_steps + 1,) int64: each step's CG, then the last


def pcg(A: Callable, b: torch.Tensor, x0: torch.Tensor, M: Callable, *,
        maxiter: int, tol: float = 1e-5):
    """Preconditioned conjugate gradient with the recurrence and stopping
    rule of ``jax.scipy.sparse.linalg.cg`` with a preconditioner ``M`` and
    atol = 0: it iterates while r.r > tol^2 b.b and fewer than ``maxiter``
    iterations have run.  Returns (x, iterations as a 0-d int64 tensor).

    The host reads the stopping rule once every ``CHECK_EVERY`` iterations;
    in between, an iteration that the rule stops leaves the iterate as it
    was (``torch.where``), so x is the one the JAX loop returns."""
    atol2 = tol * tol * torch.dot(b, b)
    x = x0
    r = b - A(x)
    p = z = M(r)
    gamma = torch.dot(r, z)
    rs = torch.dot(r, r)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    for it in range(int(maxiter)):
        active = rs > atol2
        if it % CHECK_EVERY == 0 and not bool(active):
            break
        Ap = A(p)
        alpha = gamma / torch.dot(p, Ap)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = M(r_new)
        gamma_new = torch.dot(r_new, z)
        p_new = z + (gamma_new / gamma) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
        rs = torch.where(active, torch.dot(r_new, r_new), rs)
        k = k + active
    return x, k


def phi_diag_constants(gamma, dim: int):
    """Closed-form diagonals of the self-pair kernel blocks, as 0-d tensors:
    (D_x^a D_y^a kappa)(x, x) for a in ID, LAP, DT, DIV, and the (ID, LAP)
    cross value the constraint rows' preconditioner needs.  The other
    same-point cross blocks vanish (odd in delta)."""
    g = torch.as_tensor(gamma, dtype=torch.float32)
    one = torch.ones((), dtype=torch.float32, device=g.device)
    zero = torch.zeros((), dtype=torch.float32, device=g.device)
    st0 = PairStats(kappa=one, q=zero, s=zero, dt=zero)
    return tuple(op_block(a, b, st0, g, dim) for a, b in
                 (("id", "id"), ("lap", "lap"), ("dt", "dt"), ("div", "div"),
                  ("id", "lap")))


def make_distributed_train(form, dim: int, *, mesh=None, gn_steps: int = 8,
                           cg_tol: float = 1e-7, cg_maxiter: int = 500) -> Callable:
    """``train(x_dom, x_bdy, bdy_g, rhs, gamma, nugget) -> DistTrainOut``:
    ``gn_steps`` Gauss-Newton steps from sol = 0, each one CG on the dual
    system warm-started from the previous step's mu, then one CG on Ktil
    started from w0 = M^T mu.  The Gram is freed when ``train`` returns.
    With a ``mesh`` of more than one 'model' rank, K is row-sharded over
    that axis."""
    from scasml_gp_torch.parallel.mesh import all_gather_rows, split_range

    sharded = mesh is not None and mesh.model > 1

    def train(x_dom, x_bdy, bdy_g, rhs, gamma, nugget) -> DistTrainOut:
        N, Nb = x_dom.shape[0], x_bdy.shape[0]
        dev = x_dom.device
        i1, i2, i3, i4 = N, N + Nb, 2 * N + Nb, 3 * N + Nb
        bdy_g = bdy_g.to(torch.float32)
        rhs = rhs.to(torch.float32)
        if sharded:
            phi = 4 * N + Nb
            rows = [split_range(phi, mesh.model, i) for i in range(mesh.model)]
            counts = [hi - lo for lo, hi in rows]
            K = gram_rows(x_dom, x_bdy, gamma, dim, *rows[mesh.model_index]).contiguous()

            def Kv(v):  # the row block's GEMV, gathered to length phi
                return all_gather_rows(torch.mv(K, v), mesh.model_group, counts) + nugget * v
        else:
            K = gram_matrix(x_dom, x_bdy, gamma, dim).contiguous()

            def Kv(v):
                return torch.mv(K, v) + nugget * v

        def split(sol):
            return sol[:N], sol[N:2 * N], sol[2 * N:]

        k_id, k_lap, k_dt, k_div, k_id_lap = phi_diag_constants(gamma, dim)
        ktil_diag = torch.cat([k_id.expand(N), k_id.expand(Nb), k_lap.expand(N),
                               k_dt.expand(N), k_div.expand(N)]) + nugget

        def lift(mu, f1, f3, f5):  # M^T: (Nb + N,) -> (phi,)
            mu2, mu4 = mu[:Nb], mu[Nb:]
            return torch.cat([-f1 * mu4, mu2, -f3 * mu4, mu4, -f5 * mu4])

        sol = torch.zeros((3 * N,), dtype=torch.float32, device=dev)
        mu = torch.zeros((Nb + N,), dtype=torch.float32, device=dev)
        losses, iters = [], []
        for _ in range(int(gn_steps)):
            z1, z3, z5 = split(sol)
            f1, f3, f5 = form.dF(z1, z3, z5)
            c_lin = form.F(z1, z3, z5, rhs) - f1 * z1 - f3 * z3 - f5 * z5
            m = torch.cat([bdy_g, c_lin])

            def project(v):  # M: (phi,) -> (Nb + N,)
                lin = v[i3:i4] - f1 * v[:i1] - f3 * v[i2:i3] - f5 * v[i4:]
                return torch.cat([v[i1:i2], lin])

            def A(v):  # M Ktil M^T, SPD
                return project(Kv(lift(v, f1, f3, f5)))

            # diag(M Ktil M^T): boundary rows are kernel diagonals; a
            # linearised row is r^T Ktil r for r = e_R4 - f1 e_R1 - f3 e_R3
            # - f5 e_R5, whose only same-point cross block is (ID, LAP).
            diag_f = (k_dt + f1 * f1 * k_id + f3 * f3 * k_lap + f5 * f5 * k_div
                      + 2.0 * f1 * f3 * k_id_lap
                      + nugget * (1.0 + f1 * f1 + f3 * f3 + f5 * f5))
            diag_a = torch.cat([(k_id + nugget).expand(Nb), diag_f])
            mu, k = pcg(A, m, mu, lambda r: r / diag_a, tol=cg_tol,
                        maxiter=cg_maxiter)
            b_star = Kv(lift(mu, f1, f3, f5))
            sol = torch.cat([b_star[:i1], b_star[i2:i3], b_star[i4:]])
            losses.append(torch.dot(m, mu))
            iters.append(k)

        # The exact representer weights of the final iterate: M^T mu equals
        # Ktil^{-1} b* only up to the last linearisation error.
        z1, z3, z5 = split(sol)
        b_fin = torch.cat([z1, bdy_g, z3, form.F(z1, z3, z5, rhs), z5])
        w0 = lift(mu, *form.dF(z1, z3, z5))
        w, k = pcg(Kv, b_fin, w0, lambda r: r / ktil_diag, tol=cg_tol,
                   maxiter=cg_maxiter)
        resid = torch.linalg.vector_norm(Kv(w) - b_fin) / torch.clamp_min(
            torch.linalg.vector_norm(b_fin), 1e-30)
        return DistTrainOut(
            sol=sol, right_vector=w,
            loss_history=(torch.stack(losses) if losses else
                          torch.zeros((0,), dtype=torch.float32, device=dev)),
            final_residual=resid, cg_iterations=torch.stack(iters + [k]))

    return train


def distributed_gpsolver(gp, x_dom, x_bdy, mesh=None, *, gn_steps: int = 8,
                         cg_tol: float = 1e-7, cg_maxiter: int = 500) -> DistTrainOut:
    """Train ``gp`` on its device through the dual-CG trainer, K row-sharded
    over ``mesh``'s 'model' axis where it has more than one rank, and
    install its state (the same GPState contract as ``GP.GPsolver``; the
    loss history repeats its last entry once).  Returns the trainer's
    output; the JAX package's also returns K, which is freed here."""
    x_dom = torch.as_tensor(x_dom, dtype=torch.float32, device=gp.device)
    x_bdy = torch.as_tensor(x_bdy, dtype=torch.float32, device=gp.device)
    bdy_g = gp.equation.g(x_bdy)[:, 0].to(torch.float32)
    rhs = gp.form.rhs_f(x_dom).to(torch.float32)
    gamma = torch.tensor(gp.gamma, dtype=torch.float32, device=gp.device)
    train = make_distributed_train(gp.form, gp.d, mesh=mesh, gn_steps=gn_steps,
                                   cg_tol=cg_tol, cg_maxiter=cg_maxiter)
    out = train(x_dom, x_bdy, bdy_g, rhs, gamma, gp.nugget)
    hist = out.loss_history
    if hist.shape[0]:
        hist = torch.cat([hist, hist[-1:]])
    gp.state = GPState(x_dom=x_dom, x_bdy=x_bdy, right_vector=out.right_vector,
                       sol=out.sol, gamma=gamma, loss_history=hist)
    return out
