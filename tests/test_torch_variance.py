"""Port's GP posterior variance (scasml_gp_torch.gp.variance,
GP.predict_std) against the JAX package on the same points and states.

Tolerances: ``cross_phi`` is closed-form kernel blocks, rtol = atol = 2e-4
(the posterior's bar), and so is the variance computed from one and the
same factor C = (K + nugget I)^{-1}: 1 - k^T C k cancels terms of size
~|C| k^2, so float32 summation order alone moves it by ~1e-4, and the
standard deviation near 0.05 by ~1e-3.  The two packages form C
differently in float32 (the port's cholesky_inverse, the JAX package's
Linv^T Linv), and with the trained GP's Gram (condition number ~4e5 at the
default nugget 1e-2) each misses a float64 factorization of the same
float32 Gram by a few 1e-3 in the standard deviation.  There the port is
held to be no farther from the float64 result than the JAX package.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import scasml_gp_torch as port  # noqa: E402
from scasml_gp_torch.gp import variance as tv  # noqa: E402
from scasml_gp_torch.gp.kernels import kernel_gammas  # noqa: E402
from scasml_gp_torch.gp.state import state_from_numpy  # noqa: E402
from scasml_gp_tpu.config import GPConfig as JaxGPConfig  # noqa: E402
from scasml_gp_tpu.equations import GradDependentNonlinear as JaxEq  # noqa: E402
from scasml_gp_tpu.gp import GPGradDependentNonlinear as JaxGP  # noqa: E402
from scasml_gp_tpu.gp import variance as jv  # noqa: E402

torch.set_num_threads(2)

D, NUGGET = 3, 1e-2
GAMMAS = {"iso": kernel_gammas(0.25, D),
          "ridge": kernel_gammas(0.25, D, time_scale=0.7, ridge_scale=8.0)}


@pytest.fixture(scope="module")
def sets():
    rng = np.random.default_rng(7)
    mk = lambda n: rng.uniform(-0.5, 0.5, (n, D + 1)).astype(np.float32)  # noqa: E731
    return mk(9), mk(12), mk(5)


@pytest.mark.parametrize("gname", sorted(GAMMAS))
def test_cross_phi_and_variance_match_jax(sets, gname):
    x, x_dom, x_bdy = sets
    gamma = np.asarray(GAMMAS[gname], np.float32)
    tx, td, tb = (torch.from_numpy(a) for a in sets)
    np.testing.assert_allclose(
        tv.cross_phi(tx, td, tb, torch.from_numpy(gamma), D).numpy(),
        np.asarray(jv.cross_phi(x, x_dom, x_bdy, gamma, D)), rtol=2e-4, atol=2e-4)
    C_t = tv.factor_for_variance(td, tb, torch.from_numpy(gamma), NUGGET, D)
    C_j = jv.factor_for_variance(x_dom, x_bdy, gamma, NUGGET, D)
    var_t = tv.posterior_variance(tx, td, tb, C_t, torch.from_numpy(gamma), D)
    var_j = jv.posterior_variance(x, x_dom, x_bdy, C_j, gamma, D)
    np.testing.assert_allclose(np.sqrt(var_t.numpy()), np.sqrt(np.asarray(var_j)),
                               rtol=0, atol=2e-4)
    assert torch.all(var_t >= 0.0)
    chunked = tv.posterior_variance(tx, td, tb, C_t, torch.from_numpy(gamma), D,
                                    chunk=4)
    # another row blocking of kx @ C: float32 round-off of 1 - k^T C k
    torch.testing.assert_close(chunked, var_t, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def carried():
    eq_j = JaxEq(n_input=D + 2)
    gp_j = JaxGP(eq_j, JaxGPConfig(gn_steps=4))
    x_dom, x_bdy = eq_j.generate_data(60, 14, key=jax.random.PRNGKey(0))
    gp_j.GPsolver(x_dom, x_bdy)
    gp_t = port.GPGradDependentNonlinear(port.GradDependentNonlinear(n_input=D + 2), device="cpu")
    gp_t.state = state_from_numpy(
        {k: np.asarray(v) for k, v in gp_j.state._asdict().items()}, "cpu")
    return gp_j, gp_t, np.array(x_dom)


def test_predict_std_matches_jax(carried):
    """From the JAX package's own factor C, the port's variance gives the
    JAX variance to 2e-4; with each package's own factor, the
    port is no farther than the JAX package from a float64 factorization of
    the same Gram (at fresh points and at the training points, where the
    posterior contracts)."""
    from scasml_gp_torch.gp.gram import gram_matrix

    gp_j, gp_t, x_dom = carried
    st = gp_t.state
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.5, 0.5, (64, D + 2)).astype(np.float32)
    x[:, -1] = rng.uniform(0.0, 0.5, 64)
    K = gram_matrix(st.x_dom, st.x_bdy, st.gamma, D + 1).double()
    K = 0.5 * (K + K.T) + gp_t.nugget * torch.eye(K.shape[0], dtype=torch.float64)
    C_j = jv.factor_for_variance(gp_j.state.x_dom, gp_j.state.x_bdy,
                                 gp_j.state.gamma, gp_j.nugget, D + 1)
    for pts in (x, x_dom):
        tx = torch.from_numpy(pts)
        std_j = np.asarray(gp_j.predict_std(jnp.asarray(pts))).ravel()
        same_c = tv.posterior_variance(tx, st.x_dom, st.x_bdy,
                                       torch.from_numpy(np.array(C_j)), st.gamma,
                                       D + 1)
        np.testing.assert_allclose(same_c.numpy(), std_j**2, rtol=0, atol=2e-4)
        kx = tv.cross_phi(tx, st.x_dom, st.x_bdy, st.gamma, D + 1).double()
        var64 = 1.0 - torch.sum(kx * torch.linalg.solve(K, kx.T).T, dim=1)
        std64 = torch.sqrt(torch.clamp_min(var64, 0.0)).numpy()
        err_t = np.abs(gp_t.predict_std(tx).numpy().ravel() - std64).max()
        err_j = np.abs(std_j - std64).max()
        assert err_t <= err_j + 2e-4, (err_t, err_j)
    mean, std = gp_t.predict_with_std(torch.from_numpy(x))
    assert mean.shape == std.shape == (64, 1)
    torch.testing.assert_close(mean, gp_t.predict(torch.from_numpy(x)))
    assert float(std.max()) <= 1.0 + 1e-5
    assert gp_t.predict_std(torch.from_numpy(x_dom)).mean() < std.mean()


def test_predict_std_factor_is_cached_per_state():
    eq = port.GradDependentNonlinear(n_input=D + 2)
    gp = port.GPGradDependentNonlinear(eq, port.GPConfig(gn_steps=4), device="cpu")
    x_dom, x_bdy = eq.generate_data(60, 14, torch.Generator().manual_seed(0))
    gp.GPsolver(x_dom, x_bdy)
    x = eq.geometry().sample_domain(torch.Generator().manual_seed(5), 64)
    std_a = gp.predict_std(x)
    C = gp._var_C
    gp.predict_std(x)
    assert gp._var_C is C                       # reused for the same state
    more = eq.geometry().sample_domain(torch.Generator().manual_seed(9), 60)
    gp.GPsolver(torch.cat([x_dom, more]), x_bdy)
    std_b = gp.predict_std(x)
    assert gp._var_C is not C                   # rebuilt after a retrain
    assert float(std_b.mean()) <= float(std_a.mean()) + 1e-3
