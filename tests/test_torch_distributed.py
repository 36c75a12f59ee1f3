"""Port's large-N trainer (scasml_gp_torch.gp.distributed) against the JAX
package and against the port's dense Newton trainer, on the CPU.

The single-device cases of tests/test_distributed.py (the row-sharded Gram
and the mesh are not ported), then the port against JAX's
``distributed_gpsolver`` on the same points, ``pcg`` against
``jax.scipy.sparse.linalg.cg``, and the tuner's distributed branch against
the JAX tuner's.  Both trainers start from zero and run the same float32
recurrence, so losses and predictions agree to float32 round-off amplified
by the CG (1e-3 relative).
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import scasml_gp_torch as port  # noqa: E402
from scasml_gp_torch.gp.distributed import (  # noqa: E402
    distributed_gpsolver,
    make_distributed_train,
    pcg,
    phi_diag_constants,
)
from scasml_gp_torch.gp.gram import gram_matrix  # noqa: E402
from scasml_gp_torch.gp.tuning import tune_gp  # noqa: E402
from scasml_gp_tpu.config import GPConfig as JaxGPConfig  # noqa: E402
from scasml_gp_tpu.equations import GradDependentNonlinear as JaxEq  # noqa: E402
from scasml_gp_tpu.gp import GPGradDependentNonlinear as JaxGP  # noqa: E402

torch.set_num_threads(2)

D = 6
REL = 1e-3


def _points(n_dom, n_bdy, seed=0):
    """The JAX package's equation and the port's seeded training points,
    which both packages take."""
    x_dom, x_bdy = port.GradDependentNonlinear(n_input=D + 1).generate_data(
        n_dom, n_bdy, torch.Generator().manual_seed(seed))
    return JaxEq(n_input=D + 1), x_dom, x_bdy


def _eval_points(n=128):
    eq = port.GradDependentNonlinear(n_input=D + 1)
    return eq.geometry().sample_domain(torch.Generator().manual_seed(5), n)


def _gp(cfg=None):
    eq = port.GradDependentNonlinear(n_input=D + 1)
    return port.GPGradDependentNonlinear(eq, cfg or port.GPConfig(), device="cpu")


def _rel(a, b):
    a, b = np.ravel(np.asarray(a)), np.ravel(np.asarray(b))
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_phi_diag_constants_match_gram_diagonal():
    """The closed-form preconditioner diagonals equal the assembled Gram's
    and the JAX package's constants."""
    from scasml_gp_tpu.gp.distributed import phi_diag_constants as jax_constants

    _, x_dom, x_bdy = _points(12, 4)
    gp = _gp()
    gamma = torch.tensor(gp.gamma, dtype=torch.float32)
    K = gram_matrix(x_dom, x_bdy, gamma, D).numpy()
    k_id, k_lap, k_dt, k_div, k_id_lap = map(float, phi_diag_constants(gamma, D))
    N, Nb = 12, 4
    diag = np.diagonal(K)
    np.testing.assert_allclose(diag[:N], k_id, rtol=1e-5)
    np.testing.assert_allclose(diag[N:N + Nb], k_id, rtol=1e-5)
    np.testing.assert_allclose(diag[N + Nb:2 * N + Nb], k_lap, rtol=2e-4)
    np.testing.assert_allclose(diag[2 * N + Nb:3 * N + Nb], k_dt, rtol=1e-5)
    np.testing.assert_allclose(diag[3 * N + Nb:], k_div, rtol=1e-4)
    np.testing.assert_allclose(np.diagonal(K[:N, N + Nb:2 * N + Nb]), k_id_lap, rtol=1e-4)
    want = map(float, jax_constants(jnp.asarray(gp.gamma, jnp.float32), D))
    np.testing.assert_allclose([k_id, k_lap, k_dt, k_div, k_id_lap], list(want), rtol=1e-6)


def test_distributed_matches_dense_newton():
    """Same problem through the dense Newton path and the distributed CG
    path: the two fixed points' losses and predictions agree."""
    _, x_dom, x_bdy = _points(96, 24)
    gp_dense = _gp(port.GPConfig(gn_steps=12))
    gp_dense.GPsolver(x_dom, x_bdy)
    gp = _gp()
    out = distributed_gpsolver(gp, x_dom, x_bdy, gn_steps=12)
    x_eval = _eval_points()
    assert float(out.final_residual) < 1e-3
    loss_dense = float(gp_dense.state.loss_history[-1])
    loss_dist = float(out.loss_history[-1])
    assert np.isclose(loss_dist, loss_dense, rtol=5e-2), (loss_dist, loss_dense)
    assert _rel(gp.predict(x_eval), gp_dense.predict(x_eval)) < 2e-2
    assert out.cg_iterations.shape == (13,)
    assert out.cg_iterations.dtype == torch.int64
    assert int(out.cg_iterations.min()) >= 1
    assert int(out.cg_iterations.max()) <= port.GPConfig().dist_cg_maxiter


def test_gpsolver_distributed_consumes_gn_steps():
    """GPsolver(x, y, GN_steps=k) on the distributed path runs k steps, not
    dist_gn_steps: ComputingBudget's budget axis."""
    _, x_dom, x_bdy = _points(64, 16)
    gp = _gp(port.GPConfig(train_backend="distributed", dist_gn_steps=8,
                           dist_cg_maxiter=40))
    gp.GPsolver(x_dom, x_bdy, GN_steps=3)
    assert gp.state.loss_history.shape[0] == 4


def test_gpsolver_auto_dispatches_to_distributed():
    """'auto' routes GPsolver to the distributed trainer past dense_phi_max,
    matching the dense path; below it the same config stays dense."""
    _, x_dom, x_bdy = _points(96, 24)
    gp_dense = _gp(port.GPConfig(gn_steps=12))
    gp_dense.GPsolver(x_dom, x_bdy)
    # phi = 4*96 + 24 = 408 > 100
    gp_auto = _gp(port.GPConfig(train_backend="auto", dense_phi_max=100,
                                dist_gn_steps=12))
    gp_auto.GPsolver(x_dom, x_bdy)
    x_eval = _eval_points()
    assert _rel(gp_auto.predict(x_eval), gp_dense.predict(x_eval)) < 2e-2
    assert gp_auto.state.loss_history.shape[0] == 13
    with pytest.raises(ValueError, match="sol0"):
        gp_auto.GPsolver(x_dom, x_bdy, sol0=torch.zeros(3 * 96))

    gp_small = _gp(port.GPConfig(train_backend="auto", dense_phi_max=100000,
                                 gn_steps=4))
    gp_small.GPsolver(x_dom, x_bdy)
    assert gp_small.state.loss_history.shape[0] == 5
    with pytest.raises(ValueError, match="train_backend"):
        _gp(port.GPConfig(train_backend="sharded")).GPsolver(x_dom, x_bdy)


def test_gpsolver_distributed_without_mesh():
    """No mesh: the trainer runs on the GP's device.  The parity modes
    (not ported; the constructor refuses them) are refused by the backend
    choice too, with the JAX package's error."""
    _, x_dom, x_bdy = _points(48, 16)
    gp = _gp(port.GPConfig(train_backend="distributed", dist_gn_steps=6))
    gp.GPsolver(x_dom, x_bdy)
    assert gp.state is not None
    assert gp.loss_history.shape == (7,)
    assert np.all(np.isfinite(gp.predict(x_dom).numpy()))
    gp.config = dataclasses.replace(gp.config, laplacian="subset")
    with pytest.raises(ValueError, match="exact-Laplacian"):
        gp.GPsolver(x_dom, x_bdy)


@pytest.fixture(scope="module")
def both_trained():
    from scasml_gp_tpu.gp.distributed import distributed_gpsolver as jax_solver
    from scasml_gp_tpu.parallel import make_mesh

    eq_j, x_dom, x_bdy = _points(96, 24)
    gp_j = JaxGP(eq_j, JaxGPConfig())
    out_j, _ = jax_solver(gp_j, jnp.asarray(x_dom.numpy()), jnp.asarray(x_bdy.numpy()),
                          make_mesh(data=1, model=1), gn_steps=12)
    gp_t = _gp()
    out_t = distributed_gpsolver(gp_t, x_dom, x_bdy, gn_steps=12)
    return gp_j, out_j, gp_t, out_t


def test_loss_history_matches_jax(both_trained):
    gp_j, out_j, gp_t, out_t = both_trained
    np.testing.assert_allclose(out_t.loss_history.numpy(),
                               np.asarray(out_j.loss_history), rtol=REL)
    np.testing.assert_allclose(gp_t.state.loss_history.numpy(),
                               np.asarray(gp_j.state.loss_history), rtol=REL)
    assert float(out_t.final_residual) < 1e-3
    assert float(out_j.final_residual) < 1e-3


def test_predictions_match_jax(both_trained):
    gp_j, _, gp_t, _ = both_trained
    x_eval = _eval_points()
    want = np.asarray(gp_j.predict(jnp.asarray(x_eval.numpy())))
    assert _rel(gp_t.predict(x_eval).numpy(), want) < REL
    grad_j = np.asarray(gp_j.compute_gradient(jnp.asarray(x_eval.numpy())))
    assert _rel(gp_t.compute_gradient(x_eval).numpy(), grad_j) < REL


@pytest.mark.parametrize("maxiter", [5, 300])
def test_pcg_matches_jax_cg(maxiter):
    """pcg against jax.scipy.sparse.linalg.cg on a seeded SPD system with a
    Jacobi preconditioner: cut off before convergence (5) and run to the
    stopping rule (300, which it reaches in fewer)."""
    from jax.scipy.sparse.linalg import cg

    rng = np.random.default_rng(3)
    n = 60
    B = rng.normal(size=(n, n))
    A = (B @ B.T + n * np.diag(rng.uniform(0.5, 4.0, n))).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    x0 = (0.1 * rng.normal(size=n)).astype(np.float32)
    diag = np.diagonal(A).copy()
    want, _ = cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), x0=jnp.asarray(x0),
                 tol=1e-6, maxiter=maxiter, M=lambda r: r / jnp.asarray(diag))
    At, dt = torch.from_numpy(A), torch.from_numpy(diag)
    got, k = pcg(lambda v: At @ v, torch.from_numpy(b), torch.from_numpy(x0),
                 lambda r: r / dt, tol=1e-6, maxiter=maxiter)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    if maxiter == 5:
        assert int(k) == 5
    else:
        assert 5 < int(k) < maxiter
        resid = np.linalg.norm(A @ got.numpy() - b) / np.linalg.norm(b)
        assert resid < 1e-5


def test_make_distributed_train_gn_steps_zero():
    """No Gauss-Newton step: the last CG alone, from sol = 0."""
    _, x_dom, x_bdy = _points(24, 8)
    gp = _gp()
    train = make_distributed_train(gp.form, D, gn_steps=0)
    out = train(x_dom, x_bdy, gp.equation.g(x_bdy)[:, 0], gp.form.rhs_f(x_dom),
                torch.tensor(gp.gamma, dtype=torch.float32), gp.nugget)
    assert out.loss_history.shape == (0,)
    assert out.cg_iterations.shape == (1,)
    assert torch.isfinite(out.right_vector).all()


# The dense branch's grid (tests/test_torch_tuning.py): D=6, 150 + 40 points.
TUNE_N, TUNE_NB, RIDGES, GAMMAS, SCORE_REL = 150, 40, (0.0, 5.0), (1.0, 0.1), 0.35
# A depth-1 judge: the JAX package compiles a rollout per depth, and at depth
# 1 the winner is as well separated (gamma_scale 0.1, ridge 5: ~30% below
# ridge 0 and ~20x below gamma_scale 1).
JUDGE = dict(judge_n=1, judge_M=4)


def test_tune_distributed_branch_matches_jax():
    """tune_gp(train_backend='distributed') against the JAX tuner's branch:
    the same candidates, scores within Monte-Carlo error (the judges draw
    from different generators; see tests/test_torch_tuning.py), the same
    winner, and every candidate trained with dist_gn_steps whatever
    gn_steps says."""
    from scasml_gp_tpu.gp.tuning import tune_gp as jax_tune_gp

    eq_j, x_dom, x_bdy = _points(TUNE_N, TUNE_NB)
    want = jax_tune_gp(JaxGP, eq_j, jnp.asarray(x_dom.numpy()), jnp.asarray(x_bdy.numpy()),
                       base=JaxGPConfig(dist_gn_steps=4), ridge_scales=RIDGES,
                       gamma_scales=GAMMAS, gn_steps=1, train_backend="distributed",
                       **JUDGE)
    eq = port.GradDependentNonlinear(n_input=D + 1)
    got = tune_gp(port.GPGradDependentNonlinear, eq, x_dom, x_bdy,
                  base=port.GPConfig(dist_gn_steps=4), ridge_scales=RIDGES,
                  gamma_scales=GAMMAS, gn_steps=1, train_backend="distributed",
                  **JUDGE)
    assert len(got.table) == len(want.table) == len(RIDGES) * len(GAMMAS)
    for (cfg_j, s_j), (cfg_t, s_t) in zip(want.table, got.table):
        assert cfg_t.ridge_scale == cfg_j.ridge_scale
        assert cfg_t.gamma_scale == cfg_j.gamma_scale
        assert np.isfinite(s_t) and abs(s_t / s_j - 1.0) < SCORE_REL, (cfg_t, s_t, s_j)
    assert (got.config.ridge_scale, got.config.gamma_scale) == (
        want.config.ridge_scale, want.config.gamma_scale)
