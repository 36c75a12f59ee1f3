"""Port's Gram assembly and equilibrated factorization
(scasml_gp_torch.gp.gram) against the JAX package."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from scasml_gp_torch.gp import gram as tg  # noqa: E402
from scasml_gp_torch.gp.kernels import kernel_gamma, kernel_gammas  # noqa: E402
from scasml_gp_tpu.gp import gram as jg  # noqa: E402

torch.set_num_threads(2)

D, N, NB = 4, 40, 12
GAMMAS = {
    "isotropic": kernel_gamma(0.25, D),
    "ridge": kernel_gammas(0.25, D, time_scale=0.6, ridge_scale=5.0),
}


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(3)
    x_dom = rng.uniform(-0.5, 0.5, (N, D + 1)).astype(np.float32)
    x_bdy = rng.uniform(-0.5, 0.5, (NB, D + 1)).astype(np.float32)
    return x_dom, x_bdy


def _gram(points, gamma):
    x_dom, x_bdy = points
    K_t = tg.gram_matrix(torch.from_numpy(x_dom), torch.from_numpy(x_bdy),
                         gamma, D)
    K_j = np.asarray(jg.gram_matrix(jnp.asarray(x_dom), jnp.asarray(x_bdy),
                                    gamma, D))
    return K_t, K_j


@pytest.mark.parametrize("gname", list(GAMMAS))
def test_gram_matches_jax(points, gname):
    """Same float32 closed forms on both sides: agreement to 1e-5 of the
    Gram's largest entry (a few ulps of its LAP-LAP block)."""
    K_t, K_j = _gram(points, GAMMAS[gname])
    assert K_t.shape == (4 * N + NB, 4 * N + NB)
    scale = np.abs(K_j).max()
    np.testing.assert_allclose(K_t.numpy() / scale, K_j / scale,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(K_t.numpy(), K_t.numpy().T,
                               rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("gname", list(GAMMAS))
def test_factorization_inverts_and_matches_jax(points, gname):
    """C (K + nugget I) = I in the equilibrated frame, where the float32
    Cholesky is well posed: D^{1/2} C D^{1/2} . M = I to 1e-3 (M's condition
    number at this size is ~1e3, times float32 round-off), and the port's C
    agrees with the JAX package's within the same bound."""
    K_t, K_j = _gram(points, GAMMAS[gname])
    nugget = 1e-2
    K_pert, C = tg.regularized_factorization(K_t, nugget)
    _, C_j = jg.regularized_factorization(jnp.asarray(K_j), nugget)
    K64 = K_pert.double()
    s = torch.sqrt(torch.clamp_min(torch.diagonal(0.5 * (K_t + K_t.T)).double(),
                                   1e-12) + nugget)
    M = K64 / s[:, None] / s[None, :]
    Ce = C.double() * s[:, None] * s[None, :]
    eye = torch.eye(M.shape[0], dtype=torch.float64)
    assert float((Ce @ M - eye).abs().max()) < 1e-3
    Cj_e = np.asarray(C_j, np.float64) * np.outer(s.numpy(), s.numpy())
    assert np.abs(Ce.numpy() - Cj_e).max() / np.abs(Cj_e).max() < 1e-3


def test_indefinite_input_takes_jitter_path():
    """An indefinite K fails the plain Cholesky; the first jitter (1e-3)
    succeeds, as in the JAX package: C = (K + 1e-3 I)^{-1} with unit
    diagonal (so no equilibration scale) and nugget 0."""
    K = np.eye(6, dtype=np.float32)
    K[0, 1] = K[1, 0] = 1.0005          # eigenvalues 2.0005 and -0.0005
    _, C = tg.regularized_factorization(torch.from_numpy(K), 0.0)
    assert torch.isfinite(C).all()
    want = np.linalg.inv(K.astype(np.float64) + 1e-3 * np.eye(6))
    np.testing.assert_allclose(C.numpy(), want, rtol=2e-3, atol=2e-3)
    _, C_j = jg.regularized_factorization(jnp.asarray(K), 0.0)
    np.testing.assert_allclose(C.numpy(), np.asarray(C_j), rtol=2e-3, atol=2e-3)


def test_every_jitter_failing_gives_nan_like_jax():
    K = -np.eye(5, dtype=np.float32)
    _, C = tg.regularized_factorization(torch.from_numpy(K), 1e-2)
    _, C_j = jg.regularized_factorization(jnp.asarray(K), 1e-2)
    assert torch.isnan(C).all()
    assert np.isnan(np.asarray(C_j)).all()
