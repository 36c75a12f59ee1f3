"""The port's parity mode (scasml_gp_torch.gp.parity and the switches that
use it) against the JAX package's (scasml_gp_tpu.gp.parity), mirroring
tests/test_parity.py on the same inputs, made with numpy.

Tolerances: the closed-form blocks, the Gram, the factorization and the
posterior at 1e-5 relative to each array's largest entry (both packages
evaluate the same float32 polynomials; they differ in summation order).
The parity train at 1e-3 relative, as tests/test_torch_gp.py holds the dense
train (Newton steps amplify round-off), from the JAX trainer's initial
point.  The Monte-Carlo probes in distribution: torch cannot replay JAX's
threefry draws; their control flow is checked exactly on a tiny tree with
every normal draw replaced by one constant in both packages.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import scasml_gp_torch as port  # noqa: E402
from scasml_gp_torch.gp import parity as tpar  # noqa: E402
from scasml_gp_torch.gp._subset_table import JAX_VERSION, SUBSETS  # noqa: E402
from scasml_gp_torch.picard import core as tcore  # noqa: E402
from scasml_gp_tpu.gp import parity as jpar  # noqa: E402

torch.set_num_threads(2)

D = 7
SUBSET = jpar.subset_indices(D, 5)
GAMMA = 0.9
REL = 1e-5
PAIRS = sorted([
    (jpar.ID, jpar.ID), (jpar.ID, jpar.DT), (jpar.DT, jpar.ID), (jpar.ID, jpar.DIV),
    (jpar.DIV, jpar.ID), (jpar.ID, jpar.LAPS), (jpar.LAPS, jpar.ID), (jpar.DT, jpar.DT),
    (jpar.DT, jpar.DIV), (jpar.DIV, jpar.DT), (jpar.DIV, jpar.DIV), (jpar.DT, jpar.LAPS),
    (jpar.DIV, jpar.LAPS), (jpar.LAPS, jpar.DT), (jpar.LAPS, jpar.DIV),
    (jpar.LAPS, jpar.LAPS),
], key=str)


def _close(got, want, rel=REL, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale, err_msg=what)


@pytest.fixture(scope="module")
def pts():
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.5, 0.5, (9, D + 1)).astype(np.float32)
    y = rng.uniform(-0.5, 0.5, (6, D + 1)).astype(np.float32)
    return x, y


def test_subset_table_matches_jax_random_choice():
    """Every entry of the port's table is jax.random.choice(PRNGKey(0), d,
    (5,), replace=False).  That is the first 5 of jax.random.permutation,
    which for d up to ~1600 sorts the d rows once by the random bits of the
    key's split (with threefry's partitionable counters, bits (d,) are the
    first d of bits (255,)): every d is checked that way from one draw of
    JAX's bits, and a spread of d against jax.random.choice itself (each
    call compiles for its d, ~0.4 s)."""
    assert sorted(SUBSETS) == [(d, 5) for d in range(5, 256)]
    assert JAX_VERSION == jax.__version__
    key = jax.random.PRNGKey(0)
    assert jax.config.jax_threefry_partitionable
    bits = np.asarray(jax.random.bits(jax.random.split(key)[1], (255,), jnp.uint32))
    for (d, size), got in SUBSETS.items():
        assert got == tuple(int(i) for i in np.argsort(bits[:d], kind="stable")[:size]), d
    for d in (5, 6, 7, 20, 64, 100, 101, 255):
        want = jax.random.choice(key, d, shape=(5,), replace=False)
        assert SUBSETS[(d, 5)] == tuple(int(i) for i in np.asarray(want)), d
    assert tpar.subset_indices(D, 5) == SUBSET
    with pytest.raises(ValueError, match="_subset_table"):
        tpar.subset_indices(D, 3)


@pytest.mark.parametrize("key", PAIRS, ids=lambda k: f"{k[0]}-{k[1]}")
def test_parity_block_matches_jax(pts, key):
    x, y = pts
    want = jpar.parity_block(key[0], key[1], jnp.asarray(x), jnp.asarray(y), GAMMA,
                             SUBSET, D)
    got = tpar.parity_block(key[0], key[1], torch.from_numpy(x), torch.from_numpy(y),
                            GAMMA, SUBSET, D)
    _close(got, want, what=str(key))


@pytest.mark.parametrize("fp16", [False, True])
def test_parity_gram_and_factorization_match_jax(pts, fp16):
    """The biased Gram, and the fp64 pseudo-Cholesky of the same Gram."""
    x, y = pts
    Kj = jpar.parity_gram_matrix(jnp.asarray(x), jnp.asarray(y), jnp.float32(GAMMA),
                                 SUBSET, D, fp16)
    Kt = tpar.parity_gram_matrix(torch.from_numpy(x), torch.from_numpy(y), GAMMA,
                                 SUBSET, D, fp16)
    _close(Kt, Kj, what="gram")
    np.testing.assert_allclose(Kt.numpy(), Kt.numpy().T, rtol=0, atol=1e-5)
    K = np.array(Kj)
    Kp_j, C_j = jpar.parity_factorization(K, 1e-2, fp16)
    Kp_t, C_t = tpar.parity_factorization(torch.from_numpy(K), 1e-2, fp16)
    assert Kp_t.dtype == C_t.dtype == torch.float32
    _close(Kp_t, Kp_j, what="K_pert")
    _close(C_t, C_j, what="C")
    np.testing.assert_allclose(C_t.numpy() @ Kp_t.numpy(), np.eye(K.shape[0]), atol=5e-4)


@pytest.mark.parametrize("want_grad,want_ops",
                         [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("fp16", [False, True])
def test_parity_posterior_matches_jax(pts, want_grad, want_ops, fp16):
    x, y = pts
    x_bdy = y[:2]
    rng = np.random.default_rng(4)
    r = 0.1 * rng.normal(size=(4 * y.shape[0] + 2,)).astype(np.float32)
    want = jpar.make_parity_posterior(SUBSET, fp16)(
        *(jnp.asarray(a) for a in (x, y, x_bdy, r)), GAMMA, D,
        want_grad=want_grad, want_ops=want_ops)
    got = tpar.make_parity_posterior(SUBSET, fp16)(
        *(torch.from_numpy(a) for a in (x, y, x_bdy, r)), GAMMA, D,
        want_grad=want_grad, want_ops=want_ops, chunk=4)
    for name, a, b in zip(want._fields, got, want):
        assert (a is None) == (b is None), name
        if b is not None:
            _close(a, b, what=name)


@pytest.mark.parametrize("fp16", [False, True])
def test_parity_train_end_to_end(fp16):
    """GPsolver in parity mode (biased Gram, fp64 pseudo-Cholesky, Newton)
    against the JAX package's on the same points and initial point, and the
    gradient and residual paths through the parity posterior."""
    from scasml_gp_tpu.config import GPConfig as JaxGPConfig
    from scasml_gp_tpu.equations import GradDependentNonlinear as JaxEq
    from scasml_gp_tpu.gp import GPGradDependentNonlinear as JaxGP

    eq = port.GradDependentNonlinear(n_input=D + 1)
    x_dom, x_bdy = (np.asarray(a) for a in eq.generate_data(
        120, 40, torch.Generator().manual_seed(0)))
    xt = np.asarray(eq.geometry().sample_domain(torch.Generator().manual_seed(1), 80))
    cfg = dict(laplacian="subset", parity_fp16=fp16, gn_steps=6)
    gp_j = JaxGP(JaxEq(n_input=D + 1), JaxGPConfig(**cfg))
    gp_j.GPsolver(jnp.asarray(x_dom), jnp.asarray(x_bdy))
    sol0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (3 * 120,))) * 1e-3
    gp_t = port.GPGradDependentNonlinear(eq, port.GPConfig(**cfg), device="cpu")
    gp_t.GPsolver(torch.from_numpy(x_dom), torch.from_numpy(x_bdy),
                  sol0=torch.from_numpy(sol0.astype(np.float32)))
    _close(gp_t.predict(torch.from_numpy(xt)), gp_j.predict(jnp.asarray(xt)),
           rel=1e-3, what="predict")
    exact = eq.exact_solution(torch.from_numpy(xt))[:, 0].numpy()
    pred = gp_t.predict(torch.from_numpy(xt))[:, 0].numpy()
    assert np.linalg.norm(pred - exact) / np.linalg.norm(exact) < 0.5
    _close(gp_t.compute_gradient(torch.from_numpy(xt)),
           gp_j.compute_gradient(jnp.asarray(xt)), rel=1e-3, what="gradient")
    _close(gp_t.compute_PDE_loss(torch.from_numpy(xt)),
           gp_j.compute_PDE_loss(jnp.asarray(xt)), rel=1e-3, what="residual")


def test_parity_rejects_non_isotropic_and_the_distributed_trainer():
    eq = port.GradDependentNonlinear(n_input=D + 1)
    with pytest.raises(ValueError, match="isotropic"):
        port.GPGradDependentNonlinear(eq, port.GPConfig(laplacian="subset", ridge_scale=1.0),
                                      device="cpu")
    gp = port.GPGradDependentNonlinear(
        eq, port.GPConfig(laplacian="subset", train_backend="distributed"), device="cpu")
    with pytest.raises(ValueError, match="exact-Laplacian"):
        gp.GPsolver(*eq.generate_data(20, 6, torch.Generator().manual_seed(0)))


# ------------------------------------------------ the Monte-Carlo probes
class _Terminal:
    """A PicardModel stand-in whose g records the points it is given."""

    def __init__(self, crn):
        self.seen = []
        self.model = tcore.PicardModel(
            f=None, g=self._g, leaf=None, mu=0.0, sigma=1.0, T=0.5, dim=3,
            clip=10.0, terminal_crn=crn)

    def _g(self, params, x_t):
        self.seen.append(x_t.clone())
        return x_t[:, :1]


@pytest.mark.parametrize("crn", [True, 5])
def test_terminal_crn_freezes_the_terminal_draws(crn):
    """Structural CRN: every terminal pass of one shape sees the same draws,
    whatever the stream's state, and a different frozen seed other draws."""
    x = torch.zeros((4, 3))
    t = torch.zeros((4,))
    probe = _Terminal(crn)
    a = tcore._terminal_pass(probe.model, None, x, t, torch.Generator().manual_seed(1), 8)
    b = tcore._terminal_pass(probe.model, None, x, t, torch.Generator().manual_seed(2), 8)
    assert torch.equal(probe.seen[0], probe.seen[1])
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    other = _Terminal(crn + 1 if crn is not True else 1)
    tcore._terminal_pass(other.model, None, x, t, torch.Generator().manual_seed(1), 8)
    assert not torch.equal(other.seen[0], probe.seen[0])
    free = _Terminal(False)
    tcore._terminal_pass(free.model, None, x, t, torch.Generator().manual_seed(1), 8)
    tcore._terminal_pass(free.model, None, x, t, torch.Generator().manual_seed(2), 8)
    assert not torch.equal(free.seen[0], free.seen[1])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("kw", [dict(terminal_crn=True),
                                dict(reference_semantics=True)],
                         ids=["terminal_crn", "reference_semantics"])
def test_probe_errors_match_jax_in_distribution(kw):
    """Quadrature MLP (2, 2) with a probe on, over frozen seeds and stream
    seeds: the mean rel-L2 of the port and of the JAX package agree within
    the Monte-Carlo spread (the JAX test's bar, tests/test_precision.py)."""
    from scasml_gp_tpu.equations import GradDependentNonlinear as JaxEq
    from scasml_gp_tpu.picard.mlp import MLP as JaxMLP

    d = 3
    eq = port.GradDependentNonlinear(n_input=d + 1)
    x = eq.geometry().sample_domain(torch.Generator().manual_seed(3), 48)
    exact = eq.exact_solution(x).numpy()
    errs_t, errs_j = [], []
    for s in range(3):
        skw = dict(kw, terminal_crn=s) if "terminal_crn" in kw else kw
        errs_t.append(_rel(port.MLP(eq, device="cpu", seed=s, **skw)
                           .u_solve(2, 2, x).numpy(), exact))
        solver = JaxMLP(JaxEq(n_input=d + 1), **skw)
        solver.key = jax.random.PRNGKey(s)
        errs_j.append(_rel(np.asarray(solver.u_solve(2, 2, jnp.asarray(x.numpy()))),
                           exact))
    spread = max(errs_j + errs_t) - min(errs_j + errs_t) + 1e-3
    assert abs(np.mean(errs_t) - np.mean(errs_j)) < max(3 * spread, 0.05), (errs_t, errs_j)


@pytest.mark.parametrize("jdtype,tdtype,levels", [(jnp.float16, torch.float16, 1024),
                                                  (jnp.bfloat16, torch.bfloat16, 128)],
                         ids=["float16", "bfloat16"])
def test_low_precision_normals_follow_jax_law(jdtype, tdtype, levels):
    """Path-dtype normal draws (the terminal pass, the full-history paths,
    reference_semantics' interior draws) follow jax.random.normal's law in
    float16 and bfloat16: the same support of 2^mantissa values (at most one
    value one float16 ulp apart, from erfinv's rounding) and the same mean
    and variance within 4 standard errors of 10^6 draws."""
    n = 1_000_000
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,), jdtype), np.float64)
    got = tcore._draw(torch.randn, torch.Generator().manual_seed(0), (n,), device="cpu",
                      dtype=tdtype).double().numpy()
    sw, sg = set(np.unique(want)), set(np.unique(got))
    assert len(sw) == len(sg) == levels
    assert len(sg - sw) <= 1
    for a, b in zip(sorted(sg - sw), sorted(sw - sg)):
        assert abs(a - b) <= 2.0 ** -10 * max(abs(b), 1.0), (a, b)
    se = 1 / np.sqrt(n)
    assert abs(got.mean() - want.mean()) < 4 * np.sqrt(2) * se
    assert abs(got.var() - want.var()) < 4 * np.sqrt(2) * np.sqrt(2) * se


@pytest.mark.parametrize("rollout", ["float32", "float16"])
@pytest.mark.parametrize("reference_semantics", [False, True])
def test_reference_semantics_control_flow_matches_jax(monkeypatch, rollout,
                                                      reference_semantics):
    """On a tiny quadrature tree (n = rho = 2, d = 3) with every normal draw
    replaced by the constant 0.7 in both packages, the rollouts are the same
    deterministic function: the carried delta_t, the draws' dtype and the
    float16 quantization of every level's output match the JAX package to
    float32 round-off (fp16 output steps 2**-11 relative)."""
    from scasml_gp_tpu.config import PrecisionPolicy as JaxPrecision
    from scasml_gp_tpu.equations import GradDependentNonlinear as JaxEq
    from scasml_gp_tpu.picard.mlp import MLP as JaxMLP

    def fixed_torch(sample, gen, shape, **kw):
        if sample is torch.randn:
            return torch.full(shape, 0.7, dtype=kw["dtype"], device=kw["device"])
        return sample(shape, generator=gen, **kw)

    def fixed_jax(key, shape=(), dtype=jnp.float32):
        return jnp.full(shape, 0.7, dtype)

    monkeypatch.setattr(tcore, "_draw", fixed_torch)
    monkeypatch.setattr(jax.random, "normal", fixed_jax)
    d = 3
    eq = port.GradDependentNonlinear(n_input=d + 1)
    x = eq.geometry().sample_domain(torch.Generator().manual_seed(4), 6)
    got = port.MLP(eq, device="cpu", reference_semantics=reference_semantics,
                   precision=port.PrecisionPolicy(rollout=rollout)).uz_solve(2, 2, x)
    want = JaxMLP(JaxEq(n_input=d + 1), reference_semantics=reference_semantics,
                  precision=JaxPrecision(rollout=rollout)).uz_solve(2, 2, jnp.asarray(x.numpy()))
    rel = 2.0 ** -10 if reference_semantics else 1e-5
    _close(got, want, rel=rel, what="uz")
    if reference_semantics:
        # every entry is a float16 value
        assert torch.equal(got, got.to(torch.float16).to(torch.float32))
