"""Port's HJB, SineNonlinear and AllenCahn equations and the Sine and
Allen-Cahn collocation forms (scasml_gp_torch.equations.extra,
scasml_gp_torch.gp.solver) against the JAX package on the same inputs.

Tolerances: the problem functions and forms are a few float32 operations
each, so they agree to rtol = 1e-5, atol = 1e-6.  The HJB Cole-Hopf oracle
is a Monte-Carlo estimate from another random stream: each point agrees with
the JAX one within 3 standard errors of the difference of two independent
estimates.  A Sine or Allen-Cahn collocation GP trained from the JAX
trainer's initial point agrees to relative 1e-3, the bar of
tests/test_torch_gp.py.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import scasml_gp_torch as port  # noqa: E402
from scasml_gp_torch.gp import solver as tsolver  # noqa: E402
from scasml_gp_tpu import equations as jeq  # noqa: E402
from scasml_gp_tpu.gp import solver as jsolver  # noqa: E402

torch.set_num_threads(2)

D = 4
NAMES = ("HJB", "SineNonlinear", "AllenCahn")
FLAGS = ("T", "t0", "radius", "uncertainty", "norm_estimation", "boundary_mode",
         "center_z", "time_sampling", "terminal_z", "variance_guard",
         "escalate_M", "escalate_M_accept", "escalate_M_max")
TOL = dict(rtol=1e-5, atol=1e-6)


def _points(n, d=D, seed=0, T=0.5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (n, d + 1)).astype(np.float32)
    x[:, -1] = rng.uniform(0.0, T, n)
    return x


def _pair(name, d=D):
    return jeq.EQUATIONS[name](n_input=d + 1), port.EQUATIONS[name](n_input=d + 1)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("d", [4, 100])
def test_flags_and_coefficients_match_jax(name, d):
    ej, et = _pair(name, d)
    for flag in FLAGS:
        assert getattr(et, flag, None) == getattr(ej, flag, None), flag
    assert et.sigma() == ej.sigma() and et.mu() == ej.mu()
    for fn in ("terminal_bernstein", "terminal_bernstein_v"):
        if hasattr(ej, fn):
            assert getattr(et, fn)() == getattr(ej, fn)()
        else:
            assert not hasattr(et, fn)


@pytest.mark.parametrize("name", NAMES)
def test_problem_functions_match_jax(name):
    ej, et = _pair(name)
    x = _points(64, T=ej.T)
    rng = np.random.default_rng(1)
    u = rng.normal(size=(64, 1)).astype(np.float32)
    z = rng.normal(size=(64, D)).astype(np.float32)
    xt, ut, zt = (torch.from_numpy(a) for a in (x, u, z))
    np.testing.assert_allclose(et.f(xt, ut, zt).numpy(),
                               np.asarray(ej.f(jnp.asarray(x), u, z)), **TOL)
    np.testing.assert_allclose(et.g(xt).numpy(), np.asarray(ej.g(jnp.asarray(x))),
                               **TOL)
    if name == "SineNonlinear":
        for fn in ("forcing", "exact_solution", "exact_solution_derivative"):
            np.testing.assert_allclose(getattr(et, fn)(xt).numpy(),
                                       np.asarray(getattr(ej, fn)(jnp.asarray(x))),
                                       **TOL, err_msg=fn)
    if name == "AllenCahn":
        with pytest.raises(NotImplementedError):
            et.exact_solution(xt)


@pytest.mark.parametrize("name", NAMES)
def test_samplers_follow_boundary_mode(name):
    _, et = _pair(name)
    x_dom, x_bdy = et.generate_data(50, 20, torch.Generator().manual_seed(0))
    assert x_dom.shape == (50, D + 1) and x_bdy.shape == (20, D + 1)
    if et.boundary_mode == "terminal":
        assert torch.all(x_bdy[:, -1] == et.T)
    else:
        assert torch.all(x_bdy[:, :-1].abs().amax(dim=1) == et.radius)


def test_hjb_oracle_matches_jax_within_mc_error():
    """Both oracles average exp(-g) over 8192 draws; the port's default
    stream is a generator seeded with 7.  The standard error of u = -ln m
    is sd(e^{-g}) / (m sqrt(N)) (delta method), estimated per point from
    an independent numpy sample."""
    ej, et = _pair("HJB")
    x = _points(24, seed=3)
    x[:, -1] = np.linspace(0.0, 0.45, 24)
    num_mc = 8192
    uj = np.asarray(ej.exact_solution(jnp.asarray(x), num_mc=num_mc)).ravel()
    ut = et.exact_solution(torch.from_numpy(x), num_mc=num_mc).numpy().ravel()
    rng = np.random.default_rng(5)
    w = rng.normal(size=(24, 4096, D))
    xs = x[:, None, :-1] + np.sqrt(2.0 * (0.5 - x[:, -1]))[:, None, None] * w
    e = np.exp(-np.log(0.5 * (1.0 + np.sum(xs * xs, axis=2))))
    se = e.std(axis=1) / (e.mean(axis=1) * np.sqrt(num_mc))
    assert np.all(np.abs(ut - uj) <= 3.0 * np.sqrt(2.0) * se + 1e-6), \
        np.max(np.abs(ut - uj) / (np.sqrt(2.0) * se + 1e-12))


def test_hjb_oracle_chunking_is_exact():
    """The chunked running-max log-mean-exp equals a direct float64
    -ln mean(exp(-g)) over the same draws (to float32 round-off)."""
    _, et = _pair("HJB")
    x = torch.from_numpy(_points(10, seed=4))
    got = et.exact_solution(x, gen=torch.Generator().manual_seed(3), num_mc=1024,
                            mc_chunk=256).numpy().ravel()
    gen = torch.Generator().manual_seed(3)
    w = torch.cat([torch.randn((10, 256, D), generator=gen) for _ in range(4)], 1)
    xs = (x[:, None, :-1] + torch.sqrt(2.0 * (0.5 - x[:, -1]))[:, None, None] * w)
    g = torch.log(0.5 * (1.0 + torch.sum(xs.double() ** 2, dim=2)))
    want = -torch.log(torch.mean(torch.exp(-g), dim=1)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("form,name", [("SineForm", "SineNonlinear"),
                                       ("AllenCahnForm", "AllenCahn")])
def test_forms_match_jax(form, name):
    ej, et = _pair(name)
    fj, ft = getattr(jsolver, form)(ej), getattr(tsolver, form)(et)
    rng = np.random.default_rng(2)
    z1, z3, z5, w, rhs = (rng.normal(size=40).astype(np.float32) for _ in range(5))
    x = _points(40, T=ej.T)
    tz = [torch.from_numpy(a) for a in (z1, z3, z5)]
    np.testing.assert_allclose(ft.F(*tz, torch.from_numpy(rhs)).numpy(),
                               np.asarray(fj.F(z1, z3, z5, rhs)), **TOL)
    for a, b in zip(ft.dF(*tz), fj.dF(z1, z3, z5)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    d2t = ft.d2F_contraction(torch.from_numpy(w), *tz)
    d2j = fj.d2F_contraction(w, z1, z3, z5)
    assert set(d2t) == set(d2j)
    for k in d2j:
        np.testing.assert_allclose(d2t[k].numpy(), np.asarray(d2j[k]), **TOL)
    np.testing.assert_allclose(ft.rhs_f(torch.from_numpy(x)).numpy(),
                               np.asarray(fj.rhs_f(jnp.asarray(x))), **TOL)
    ops = [rng.normal(size=40).astype(np.float32) for _ in range(4)]
    np.testing.assert_allclose(
        ft.residual(torch.from_numpy(x), *(torch.from_numpy(o) for o in ops)).numpy(),
        np.asarray(fj.residual(jnp.asarray(x), *ops)), **TOL)


@pytest.mark.parametrize("cls,name", [("GPSineNonlinear", "SineNonlinear"),
                                      ("GPAllenCahn", "AllenCahn")])
def test_collocation_gp_trains_to_the_jax_result(cls, name):
    """Same points, same initial point: the collocation GP (for Sine, with
    the nonzero rhs = -R(x) in its loss) trains to the JAX package's
    weights and loss."""
    N, NB, STEPS = 60, 20, 10
    ej, et = _pair(name)
    x_dom, x_bdy = (np.array(a) for a in
                    ej.generate_data(N, NB, key=jax.random.PRNGKey(4)))
    gp_j = getattr(jsolver, cls)(ej, jsolver.GPConfig(gn_steps=STEPS))
    gp_j.GPsolver(jnp.asarray(x_dom), jnp.asarray(x_bdy))
    sol0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (3 * N,))) * 1e-3
    gp_t = getattr(port.gp, cls)(et, port.GPConfig(gn_steps=STEPS), device="cpu")
    gp_t.GPsolver(torch.from_numpy(x_dom), torch.from_numpy(x_bdy),
                  sol0=torch.from_numpy(sol0.astype(np.float32)))
    np.testing.assert_allclose(gp_t.state.loss_history.numpy(),
                               np.asarray(gp_j.state.loss_history), rtol=1e-3)
    for field in ("right_vector", "sol"):
        want = np.asarray(getattr(gp_j.state, field))
        got = getattr(gp_t.state, field).numpy()
        assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max(), field
    if name == "AllenCahn":  # no closed form to score against
        return
    x = _points(80, seed=6)
    exact = np.asarray(ej.exact_solution(jnp.asarray(x))).ravel()
    e_j = np.linalg.norm(np.asarray(gp_j.predict(jnp.asarray(x))).ravel() - exact)
    e_t = np.linalg.norm(gp_t.predict(torch.from_numpy(x)).numpy().ravel() - exact)
    assert abs(e_t - e_j) <= 1e-3 * e_j + 1e-6
    assert e_t / np.linalg.norm(exact) < 0.3
