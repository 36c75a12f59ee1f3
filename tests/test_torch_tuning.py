"""Port's kernel tuner (scasml_gp_torch.gp.tuning) and its train entry
(GP._train) against the JAX package, at D=6 on 150 + 40 points with 8
Newton steps (the tests/test_tuning.py problem).

Scores are Monte-Carlo estimates from different generators on the two
sides, so they agree within Monte-Carlo error: over 8 judge seeds of the
port a score's relative standard deviation was 0.04 to 0.10 on this problem,
so the difference of two independent scores has one of at most 0.14, and the
bar is 0.35.  The candidates share their draws on each side (common random
numbers), so a whole table can sit above or below the other by a common
factor; the ranking does not move with it.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import scasml_gp_torch as port  # noqa: E402
from scasml_gp_torch.gp.tuning import tune_gp, validation_score  # noqa: E402
from scasml_gp_tpu.config import GPConfig as JaxGPConfig  # noqa: E402
from scasml_gp_tpu.equations import GradDependentNonlinear as JaxEq  # noqa: E402
from scasml_gp_tpu.gp import GPGradDependentNonlinear as JaxGP  # noqa: E402

torch.set_num_threads(2)

D, N, NB, STEPS = 6, 150, 40, 8
SCORE_REL = 0.35
# Trained weights: float32 round-off of the factorization, amplified by the
# Gram's condition number.  Against a float64 solve of the same float32
# Gram, the JAX package's weights at gamma_scale 1 were off by up to 4.5e-3
# of their largest entry, the port's by up to 4.4e-4 (at gamma_scale 0.1
# the JAX package's were off by 2.8e-2, so those candidates are not compared
# here).
RV_REL = 1e-2
# A 2 x 2 grid whose winner is well separated: gamma_scale 0.1 scores ~10x
# below 1.0, and ridge 5 ~30% below ridge 0 at gamma_scale 0.1.
RIDGES, GAMMAS = (0.0, 5.0), (1.0, 0.1)


@pytest.fixture(scope="module")
def points():
    eq_j = JaxEq(n_input=D + 1)
    x_dom, x_bdy = eq_j.generate_data(N, NB, key=jax.random.PRNGKey(0))
    return eq_j, np.array(x_dom), np.array(x_bdy)


@pytest.fixture(scope="module")
def tables(points):
    from scasml_gp_tpu.gp.tuning import tune_gp as jax_tune_gp

    eq_j, x_dom, x_bdy = points
    want = jax_tune_gp(JaxGP, eq_j, jnp.asarray(x_dom), jnp.asarray(x_bdy),
                       base=JaxGPConfig(gn_steps=STEPS), ridge_scales=RIDGES,
                       gamma_scales=GAMMAS, gn_steps=STEPS)
    eq = port.GradDependentNonlinear(n_input=D + 1)
    got = tune_gp(port.GPGradDependentNonlinear, eq, torch.from_numpy(x_dom),
                  torch.from_numpy(x_bdy), base=port.GPConfig(gn_steps=STEPS),
                  ridge_scales=RIDGES, gamma_scales=GAMMAS, gn_steps=STEPS)
    return want, got


def _fields(cfg):
    return dataclasses.asdict(cfg)


def test_score_table_matches_jax(tables):
    want, got = tables
    assert len(got.table) == len(want.table) == len(RIDGES) * len(GAMMAS)
    for (cfg_j, s_j), (cfg_t, s_t) in zip(want.table, got.table):
        assert _fields(cfg_t) == _fields(cfg_j)
        assert np.isfinite(s_t) and s_t > 0
        assert abs(s_t / s_j - 1.0) < SCORE_REL, (cfg_t, s_t, s_j)
    assert got.score == min(s for _, s in got.table)


def test_winner_matches_jax(tables):
    want, got = tables
    ranked = sorted(s for _, s in want.table)
    assert ranked[1] > 1.2 * ranked[0]  # the premise: a separated winner
    assert _fields(got.config) == _fields(want.config)


@pytest.mark.parametrize("ridge,gscale", [(0.0, 1.0), (5.0, 1.0)])
def test_train_with_jax_sol0_matches_jax_weights(points, ridge, gscale):
    """GP._train, the tuner's per-candidate train, from the JAX trainer's own
    initial point: the representer weights agree to RV_REL of their largest
    entry and the final loss to 1e-3 relative."""
    eq_j, x_dom, x_bdy = points
    gp_j = JaxGP(eq_j, JaxGPConfig(gn_steps=STEPS, ridge_scale=ridge,
                                    gamma_scale=gscale))
    xd, xb = jnp.asarray(x_dom), jnp.asarray(x_bdy)
    cfg = gp_j.config
    want = gp_j._train_jit(
        xd, xb, eq_j.g(xb)[:, 0], gp_j.form.rhs_f(xd),
        jnp.asarray(gp_j.gamma, jnp.float32), jnp.float32(cfg.nugget),
        steps=STEPS, damping=cfg.damping, grad_tol=cfg.grad_tol,
        init_scale=cfg.init_scale,
    )
    sol0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (3 * N,))) * cfg.init_scale

    eq = port.GradDependentNonlinear(n_input=D + 1)
    gp = port.GPGradDependentNonlinear(
        eq, port.GPConfig(gn_steps=STEPS, ridge_scale=ridge, gamma_scale=gscale), device="cpu")
    xd_t, xb_t = torch.from_numpy(x_dom), torch.from_numpy(x_bdy)
    got = gp._train(
        xd_t, xb_t, eq.g(xb_t)[:, 0], gp.form.rhs_f(xd_t),
        torch.tensor(gp.gamma, dtype=torch.float32), cfg.nugget, STEPS,
        cfg.damping, cfg.grad_tol, torch.from_numpy(sol0.astype(np.float32)),
    )
    rv = np.asarray(want.right_vector)
    assert np.abs(got.right_vector.numpy() - rv).max() <= RV_REL * np.abs(rv).max()
    np.testing.assert_allclose(got.loss_history[-1].item(),
                               float(want.loss_history[-1]), rtol=1e-3)


def test_validation_score_matches_jax(points):
    """The diagnostic residual score of the same trained surrogate (same
    sol0 on both sides) agrees to 1e-2 relative."""
    from scasml_gp_tpu.gp.tuning import validation_score as jax_validation_score

    eq_j, x_dom, x_bdy = points
    gp_j = JaxGP(eq_j, JaxGPConfig(gn_steps=6))
    gp_j.GPsolver(jnp.asarray(x_dom[:80]), jnp.asarray(x_bdy[:20]))
    v_dom, v_bdy = (np.array(a) for a in
                    eq_j.generate_data(30, 10, key=jax.random.PRNGKey(3)))
    want = jax_validation_score(gp_j, jnp.asarray(v_dom), jnp.asarray(v_bdy))

    eq = port.GradDependentNonlinear(n_input=D + 1)
    gp = port.GPGradDependentNonlinear(eq, port.GPConfig(gn_steps=6), device="cpu")
    sol0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (240,))) * 1e-3
    gp.GPsolver(torch.from_numpy(x_dom[:80]), torch.from_numpy(x_bdy[:20]),
                sol0=torch.from_numpy(sol0.astype(np.float32)))
    got = validation_score(gp, torch.from_numpy(v_dom), torch.from_numpy(v_bdy))
    assert np.isfinite(got) and got >= 0
    assert abs(got / want - 1.0) < 1e-2, (got, want)


def test_judge_scores_and_unported_backend(points):
    """Any judge_score other than 'cross' is 'energy' (the JAX package's
    behaviour, kept); 'cross' gives finite positive scores; an unknown
    train_backend raises (the distributed one, once unported, is held
    against the JAX package in tests/test_torch_distributed.py)."""
    _, x_dom, x_bdy = points
    eq = port.GradDependentNonlinear(n_input=D + 1)
    args = (port.GPGradDependentNonlinear, eq, torch.from_numpy(x_dom[:60]),
            torch.from_numpy(x_bdy[:20]))
    kw = dict(base=port.GPConfig(gn_steps=4), ridge_scales=(0.0,),
              gamma_scales=(1.0, 0.1), judge_val_sets=1)
    energy = tune_gp(*args, **kw)
    other = tune_gp(*args, judge_score="variance", **kw)
    assert [s for _, s in other.table] == [s for _, s in energy.table]
    cross = tune_gp(*args, judge_score="cross", **kw)
    assert all(np.isfinite(s) and s > 0 for _, s in cross.table)
    with pytest.raises(ValueError, match="train_backend"):
        tune_gp(*args, train_backend="sharded", **kw)


def test_judge_uses_common_random_numbers(points):
    """Every candidate is judged with the same draws: a candidate's score
    does not depend on which candidates were judged before it."""
    _, x_dom, x_bdy = points
    eq = port.GradDependentNonlinear(n_input=D + 1)
    args = (port.GPGradDependentNonlinear, eq, torch.from_numpy(x_dom[:60]),
            torch.from_numpy(x_bdy[:20]))
    kw = dict(base=port.GPConfig(gn_steps=4), ridge_scales=(0.0,),
              judge_val_sets=2)
    both = tune_gp(*args, gamma_scales=(1.0, 0.1), **kw)
    alone = tune_gp(*args, gamma_scales=(0.1,), **kw)
    assert both.table[1][1] == alone.table[0][1]
