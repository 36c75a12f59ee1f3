"""Port's closed-form kernel blocks (scasml_gp_torch.gp.kernels) against the
JAX package on identical inputs, and a few blocks against torch.autograd.

Tolerance against JAX: rtol = atol = 1e-5 on values scaled by the block's
largest magnitude.  Both sides evaluate the same float32 formulas; they
differ only in the order of the x.y^T sums and of the elementwise products,
which moves results by a few float32 ulps of the block's largest terms.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from scasml_gp_torch.gp import kernels as tk  # noqa: E402
from scasml_gp_tpu.gp import kernels as jk  # noqa: E402

torch.set_num_threads(2)

D = 4
OPS = (tk.ID, tk.LAP, tk.DT, tk.DIV)
GAMMAS = {
    "isotropic": tk.kernel_gamma(0.25, D),
    "separable": tk.kernel_gammas(0.25, D, time_scale=0.6),
    "ridge": tk.kernel_gammas(0.25, D, time_scale=0.6, ridge_scale=5.0),
}


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(7)
    x = rng.uniform(-0.5, 0.5, (23, D + 1)).astype(np.float32)
    y = rng.uniform(-0.5, 0.5, (31, D + 1)).astype(np.float32)
    return x, y


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


def _stats(points, gamma):
    x, y = points
    return (tk.pair_stats(torch.from_numpy(x), torch.from_numpy(y), gamma),
            jk.pair_stats(jnp.asarray(x), jnp.asarray(y), gamma))


@pytest.mark.parametrize("gname", list(GAMMAS))
def test_pair_stats_match_jax(points, gname):
    ts, js = _stats(points, GAMMAS[gname])
    for name, a, b in zip(ts._fields, ts, js):
        _close(a.numpy(), b, tol=1e-5)


@pytest.mark.parametrize("gname", list(GAMMAS))
@pytest.mark.parametrize("a", OPS)
@pytest.mark.parametrize("b", OPS)
def test_op_block_matches_jax(points, gname, a, b):
    gamma = GAMMAS[gname]
    ts, js = _stats(points, gamma)
    _close(tk.op_block(a, b, ts, gamma, D).numpy(),
           jk.op_block(a, b, js, gamma, D))


@pytest.mark.parametrize("gname", list(GAMMAS))
@pytest.mark.parametrize("b", OPS)
def test_grad_coeffs_match_jax(points, gname, b):
    gamma = GAMMAS[gname]
    ts, js = _stats(points, gamma)
    got = tk.grad_coeffs(b, ts, gamma, D)
    want = jk.grad_coeffs(b, js, gamma, D)
    for a, w in zip(got, want):
        _close(a.numpy(), w)


def test_split_gamma_and_gammas_match_jax():
    for g in (0.3, [0.3, 0.2], [0.3, 0.2, 0.1]):
        np.testing.assert_allclose(
            [float(v) for v in tk.split_gamma(g)],
            [float(v) for v in jk.split_gamma(g)], rtol=0, atol=0)
    assert tk.kernel_gammas(0.25, 20, 0.5, 3.0) == jk.kernel_gammas(0.25, 20, 0.5, 3.0)


# ---------------------------------------------------------------- autograd
def _kappa64(x, y, gamma):
    """Base kernel from the differences, float64, differentiable in x and y."""
    gs, gt, gr = (float(v) for v in tk.split_gamma(gamma))
    delta = x[:, None, :] - y[None, :, :]
    q = (delta[..., :-1] ** 2).sum(-1)
    s = delta[..., :-1].sum(-1)
    dt = delta[..., -1]
    return torch.exp(-0.5 * (gs * q + gr * s * s + gt * dt * dt))


def _x_derivs(points, gamma):
    """kappa and its x-gradient and spatial x-Laplacian by autograd, for one
    row of x against every y."""
    x, y = (torch.from_numpy(v).double() for v in points)
    x0 = x[:1].clone().requires_grad_(True)
    k = _kappa64(x0, y, gamma)[0]
    grads = torch.stack([
        torch.autograd.grad(k[j], x0, create_graph=True)[0][0]
        for j in range(y.shape[0])
    ])                                               # (m, d+1)
    lap = torch.stack([
        sum(torch.autograd.grad(grads[j, i], x0, retain_graph=True)[0][0, i]
            for i in range(D))
        for j in range(y.shape[0])
    ])
    return k.detach(), grads.detach(), lap.detach()


@pytest.mark.parametrize("gname", ["isotropic", "ridge"])
def test_one_sided_blocks_match_autograd(points, gname):
    gamma = GAMMAS[gname]
    x, y = points
    st = tk.pair_stats(torch.from_numpy(x[:1]), torch.from_numpy(y), gamma)
    k, grads, lap = _x_derivs(points, gamma)
    _close(tk.op_block(tk.ID, tk.ID, st, gamma, D)[0].numpy(), k.numpy(), 1e-5)
    _close(tk.op_block(tk.DT, tk.ID, st, gamma, D)[0].numpy(),
           grads[:, -1].numpy(), 1e-5)
    _close(tk.op_block(tk.DIV, tk.ID, st, gamma, D)[0].numpy(),
           grads[:, :-1].sum(1).numpy(), 1e-5)
    _close(tk.op_block(tk.LAP, tk.ID, st, gamma, D)[0].numpy(), lap.numpy(),
           1e-5)


@pytest.mark.parametrize("gname", ["isotropic", "ridge"])
def test_id_grad_coeffs_match_autograd(points, gname):
    """grad_x kappa assembled from grad_coeffs(ID) in its basis
    {delta_sp, s 1_sp, 1_sp, dt e_t, e_t}."""
    gamma = GAMMAS[gname]
    x, y = points
    st = tk.pair_stats(torch.from_numpy(x[:1]), torch.from_numpy(y), gamma)
    gc = tk.grad_coeffs(tk.ID, st, gamma, D)
    delta = torch.from_numpy(x[:1] - y)              # (m, d+1)
    g_sp = (gc.a_sp[0][:, None] * delta[:, :-1]
            + (gc.b_s[0] * st.s[0])[:, None] + gc.c[0][:, None])
    g_t = gc.a_t[0] * st.dt[0] + gc.e[0]
    _, grads, _ = _x_derivs(points, gamma)
    _close(g_sp.numpy(), grads[:, :-1].numpy(), 1e-5)
    _close(g_t.numpy(), grads[:, -1].numpy(), 1e-5)
