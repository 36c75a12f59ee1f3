"""The plain reference against autograd and against the port, on the CPU at
a tiny size: the Gram's derivative blocks, the posterior, the train and
small solves of both recursions."""

import numpy as np
import pytest
import torch
from torch.func import grad, hessian

from benchmark import compare, inputs
from benchmark.reference import gp as rgp
from benchmark.reference import picard as rpicard

D = 3


def _k(kern):
    def k(x, y):
        dx, tau = x[:-1] - y[:-1], x[-1] - y[-1]
        return torch.exp(-0.5 * (kern.gs * (dx * dx).sum() + kern.gr * dx.sum() ** 2
                                 + kern.gt * tau * tau))
    return k


def _op(f, name, arg):
    if name == "id":
        return f
    if name == "dt":
        return lambda x, y: grad(f, argnums=arg)(x, y)[-1]
    if name == "div":
        return lambda x, y: grad(f, argnums=arg)(x, y)[:-1].sum()
    return lambda x, y: torch.diagonal(hessian(f, argnums=arg)(x, y))[:-1].sum()


@pytest.mark.parametrize("ridge,gamma", [(0.0, 1.0), (30.0, 0.3)])
def test_gram_blocks_equal_autograd(ridge, gamma):
    kern = rgp.kernel_for(0.25, D, ridge, gamma)
    g = torch.Generator().manual_seed(3)
    xd = torch.rand((3, D + 1), generator=g, dtype=torch.float64) - 0.3
    xb = torch.rand((2, D + 1), generator=g, dtype=torch.float64) - 0.3
    K = rgp.gram(xd, xb, kern)
    pts = {"dom": xd, "bdy": xb}
    row = 0
    for a, sa in zip(rgp.FAMILIES, rgp.SETS):
        for i in range(pts[sa].shape[0]):
            col = 0
            for b, sb in zip(rgp.FAMILIES, rgp.SETS):
                f = _op(_op(_k(kern), b, 1), a, 0)
                for j in range(pts[sb].shape[0]):
                    want = f(pts[sa][i], pts[sb][j])
                    assert float(K[row, col]) == pytest.approx(float(want), rel=1e-9, abs=1e-9)
                    col += 1
            row += 1


def _port_trained(d=D, N=30, Nb=8, steps=20, seed=11):
    """The port's GP and the reference trained on the same points."""
    cfg = {"dim": d, "num_domain": N, "num_boundary": Nb, "gn_steps": steps, "nugget": 1e-2,
           "equation": "GradDependentNonlinear"}
    xd, xb = inputs.collocation(cfg, seed, "cpu")
    eq, gp = compare.port_gp(cfg, "cpu")
    u = gp.GPsolver(xd, xb)[:, 0].numpy()
    return cfg, eq, gp, xd, xb, u


def _with_port_weights(gp) -> rgp.Trained:
    """The reference's posterior over the port's own trained weights: to
    hold the reference's posterior and recursion to the port's alone."""
    st = gp.state
    # the port keeps its precisions, and forms its coefficients (G, beta),
    # in float32: the same precisions here, and 1e-6 below for the rest
    kern = rgp.Kernel(*(float(v) for v in st.gamma), gp.d)
    return rgp.Trained(st.x_dom.double(), st.x_bdy.double(), kern,
                       st.right_vector.double(), st.sol.double(), st.loss_history.double())


def test_posterior_equals_the_ports_float64():
    from scasml_gp_torch.gp.posterior import posterior_block

    _, _, gp, _, _, _ = _port_trained()
    st = gp.state
    x = torch.rand((17, D + 1), generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    want = posterior_block(x, st.x_dom, st.x_bdy, st.right_vector, st.gamma, D, True, True,
                           operand_dtype=torch.float64)
    got = rgp.posterior(_with_port_weights(gp), x, want_grad=True, want_ops=True, block=5)
    for g, w in ((got.u, want.u), (got.grad, want.grad[:, :-1]), (got.dt, want.dt_u),
                 (got.div, want.div_u), (got.lap, want.lap_u)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-6)


def test_train_agrees_with_the_port():
    cfg, _, _, xd, xb, u = _port_trained()
    ref = compare.reference_train(cfg, xd, xb)
    assert compare.gap(u, rgp.posterior(ref, ref.x_dom).u.numpy()) < 2e-3


@pytest.mark.parametrize("solver", ["quadrature", "full_history"])
def test_solve_agrees_with_the_port_on_its_weights(solver):
    import scasml_gp_torch as port

    _, eq, gp, _, _, _ = _port_trained()
    x = torch.rand((9, D + 1), generator=torch.Generator().manual_seed(6))
    x[:, :-1] -= 0.5
    x[:, -1] *= 0.5
    if solver == "quadrature":
        s = port.ScaSML(eq, gp, seed=5)
        got = s.u_solve(2, 2, x)[:, 0].numpy()
    else:
        s = port.ScaSMLFullHistory(eq, gp, seed=5)
        got = s.u_solve(2, None, x, M=3)[:, 0].numpy()
    gen = torch.Generator().manual_seed(5)
    want = rpicard.solve(rpicard.Problem(_with_port_weights(gp)), x.double(), gen, solver, 2)
    assert compare.gap(got, want.numpy()) < 1e-5
