"""The port's bf16 precision policy (PrecisionPolicy(gram='bfloat16'),
``--bf16``) against the JAX package's, mirroring tests/test_precision.py.

On the CPU both packages round the same operands to bfloat16 (round to
nearest even) and form exact float32 products, so they compute the same
function up to summation order.  Tolerances: the bf16 Gram at 1e-5 relative
to its largest entry; the bf16 posterior at rtol = atol = 2e-4, the float32
posterior's bar (tests/test_torch_posterior.py), which is looser; the bf16
train against the float32 one at the JAX test's bar.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import scasml_gp_torch as port  # noqa: E402
from scasml_gp_torch.gp import fused_posterior as tfp  # noqa: E402
from scasml_gp_torch.gp.gram import gram_matrix  # noqa: E402
from scasml_gp_torch.gp.kernels import kernel_gammas  # noqa: E402
from scasml_gp_torch.gp.posterior import posterior_block, posterior_eval  # noqa: E402
from scasml_gp_torch.harness import runner  # noqa: E402
from scasml_gp_tpu.gp.gram import gram_matrix as jax_gram_matrix  # noqa: E402
from scasml_gp_tpu.gp.posterior import posterior_eval as jax_posterior_eval  # noqa: E402

torch.set_num_threads(2)

D = 4
BF16 = port.PrecisionPolicy(gram="bfloat16", rollout="bfloat16")
GAMMAS = {
    "isotropic": (1.0, 1.0, 0.0),
    "separable+ridge": kernel_gammas(0.25, D, time_scale=0.6, ridge_scale=5.0),
}
FLAGS = [(False, False), (True, False), (False, True), (True, True)]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    x_dom = rng.uniform(-0.5, 0.5, (48, D + 1)).astype(np.float32)
    x_bdy = rng.uniform(-0.5, 0.5, (12, D + 1)).astype(np.float32)
    x = rng.uniform(-0.5, 0.5, (45, D + 1)).astype(np.float32)
    r = 0.1 * rng.normal(size=(4 * 48 + 12,)).astype(np.float32)
    return x, x_dom, x_bdy, r


def test_precision_policy_dtypes():
    with pytest.raises(ValueError):
        port.PrecisionPolicy(gram="float16")
    assert BF16.gram_dtype == torch.bfloat16
    assert port.PrecisionPolicy().rollout_dtype == torch.float32


@pytest.mark.parametrize("gname", list(GAMMAS))
def test_bf16_gram_matches_jax(problem, gname):
    """The bf16 Gram against the JAX package's at 1e-5 relative, float32,
    and within bf16 rounding of the float32 Gram (the JAX test's 2e-2)."""
    _, x_dom, x_bdy, _ = problem
    gamma = GAMMAS[gname]
    want = np.asarray(jax_gram_matrix(jnp.asarray(x_dom), jnp.asarray(x_bdy),
                                      jnp.asarray(gamma, jnp.float32), D, "bfloat16"))
    got = gram_matrix(torch.from_numpy(x_dom), torch.from_numpy(x_bdy),
                      torch.tensor(gamma), D, torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    K32 = gram_matrix(torch.from_numpy(x_dom), torch.from_numpy(x_bdy),
                      torch.tensor(gamma), D)
    assert 0 < _rel(got.numpy(), K32.numpy()) < 2e-2


@pytest.mark.parametrize("gname", list(GAMMAS))
@pytest.mark.parametrize("want_grad,want_ops", FLAGS)
def test_bf16_posterior_matches_jax(problem, gname, want_grad, want_ops):
    """posterior_block and the kernel's plain twin stacked_posterior with
    bf16 operands against the JAX posterior with operand_dtype='bfloat16';
    the gradient's contractions use the unrounded rows in all three."""
    x, x_dom, x_bdy, r = problem
    gamma = GAMMAS[gname]
    want = jax_posterior_eval(*(jnp.asarray(a) for a in problem), gamma, D,
                              want_grad=want_grad, want_ops=want_ops,
                              operand_dtype="bfloat16")
    t = [torch.from_numpy(a) for a in problem]
    fused = tfp.prepare_inputs(*t[1:], gamma, D, operand_dtype=torch.bfloat16)
    outs = {
        "posterior_block": posterior_block(*t, gamma, D, want_grad, want_ops,
                                           operand_dtype=torch.bfloat16),
        "stacked_posterior": tfp.stacked_posterior(t[0], fused, want_grad, want_ops),
        "posterior_eval": posterior_eval(*t, gamma, D, want_grad, want_ops, chunk=16,
                                         operand_dtype="bfloat16"),
    }
    f32 = posterior_block(*t, gamma, D, want_grad, want_ops)
    for what, got in outs.items():
        for name, a, b in zip(want._fields, got, want):
            assert (a is None) == (b is None), (what, name)
            if b is not None:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                           atol=2e-4, err_msg=f"{what} {name}")
    assert not torch.equal(outs["posterior_block"].u, f32.u)  # the policy took effect


def test_bf16_fused_inputs_keep_unrounded_rows(problem):
    """The bf16 variant's inputs: the same columns of unrounded rows and
    weights, with the row stats of the rounded rows; a bf16 state caches
    them beside the float32 ones."""
    _, x_dom, x_bdy, r = problem
    t = [torch.from_numpy(a) for a in (x_dom, x_bdy, r)]
    f32 = tfp.prepare_inputs(*t, GAMMAS["isotropic"], D)
    f16 = tfp.prepare_inputs(*t, GAMMAS["isotropic"], D, operand_dtype="bfloat16")
    assert f16.operand_dtype == torch.bfloat16 and f32.operand_dtype == torch.float32
    F = D + 1
    assert torch.equal(f16.cols[:F + 4], f32.cols[:F + 4])  # y, then the weights
    y16 = f32.y.to(torch.bfloat16).to(torch.float32)
    torch.testing.assert_close(f16.y_stats[:, 0], (y16 * y16).sum(1), rtol=1e-6, atol=0)
    assert not torch.equal(f16.y_stats, f32.y_stats)
    st = port.GPState(x_dom=t[0], x_bdy=t[1], right_vector=t[2], sol=t[2][:3],
                      gamma=torch.tensor(GAMMAS["isotropic"]), loss_history=t[2][:1])
    assert st.fused_inputs(torch.bfloat16) is st.fused_inputs("bfloat16")
    assert st.fused_inputs() is not st.fused_inputs(torch.bfloat16)
    with pytest.raises(ValueError, match="operand dtype"):
        st.fused_inputs(torch.float16)


def test_bf16_gp_train_within_tolerance():
    """End-to-end GP train with the bf16 policy lands close to float32 (the
    JAX test's bar), and against the JAX package's bf16 train on the same
    points."""
    from scasml_gp_tpu.config import GPConfig as JaxGPConfig
    from scasml_gp_tpu.config import PrecisionPolicy as JaxPrecision
    from scasml_gp_tpu.equations import GradDependentNonlinear as JaxEq
    from scasml_gp_tpu.gp import GPGradDependentNonlinear as JaxGP

    eq = port.GradDependentNonlinear(n_input=D + 1)
    x_dom, x_bdy = eq.generate_data(80, 16, torch.Generator().manual_seed(1))
    x_test = eq.geometry().sample_domain(torch.Generator().manual_seed(2), 128)
    exact = eq.exact_solution(x_test).numpy()
    errs, preds = {}, {}
    for name, prec in (("fp32", None), ("bf16", BF16)):
        gp = port.GPGradDependentNonlinear(eq, port.GPConfig(gn_steps=8), precision=prec,
                                           device="cpu")
        gp.GPsolver(x_dom, x_bdy)
        preds[name] = gp.predict(x_test).numpy()
        errs[name] = _rel(preds[name], exact)
    assert errs["bf16"] < 0.5
    assert abs(errs["bf16"] - errs["fp32"]) < 0.25 * max(errs["fp32"], 1e-3)
    gp_j = JaxGP(JaxEq(n_input=D + 1), JaxGPConfig(gn_steps=8),
                 precision=JaxPrecision(gram="bfloat16", rollout="bfloat16"))
    gp_j.GPsolver(jnp.asarray(x_dom.numpy()), jnp.asarray(x_bdy.numpy()))
    want = np.asarray(gp_j.predict(jnp.asarray(x_test.numpy())))
    # the Newton steps start from different draws of the same N(0, 1e-6) law
    assert _rel(preds["bf16"], want) < 1e-2


def test_bf16_rollout_within_mc_error():
    """bf16 path storage changes the Picard estimate by less than its own
    Monte-Carlo spread (the JAX test's bar)."""
    eq = port.GradDependentNonlinear(n_input=D + 1)
    x_t = eq.geometry().sample_domain(torch.Generator().manual_seed(3), 64)
    exact = eq.exact_solution(x_t).numpy()

    def err(prec, seed):
        s = port.MLPFullHistory(eq, precision=prec, device="cpu", seed=seed)
        return _rel(s.u_solve(2, 2, x_t, M=4).numpy(), exact)

    e32 = [err(None, s) for s in range(3)]
    e16 = [err(BF16, s) for s in range(3)]
    spread = max(e32) - min(e32) + 1e-3
    assert abs(np.mean(e16) - np.mean(e32)) < max(3 * spread, 0.05), (e32, e16)


def test_runner_bf16(tmp_path):
    """runner --bf16 at d=3 builds every solver with the bf16 policy, and
    its GP differs from the float32 run's only by bf16 rounding."""
    def argv(*extra):
        return ["--dim", "3", "--num-domain", "60", "--num-boundary", "16",
                "--test-domain", "40", "--test-boundary", "8", "--device", "cpu",
                "--no-tune", "--no-plots", "--variant", "full_history", "--M", "2",
                "--save-path", str(tmp_path / (extra[0] if extra else "fp32")), *extra]

    config = port.RunConfig(dim=3, precision=BF16)
    _, gp, mlp, sca = runner.build_solvers(config, torch.device("cpu"))
    assert gp.precision == mlp.precision == sca.precision == BF16
    out16 = runner.main(argv("--bf16"))
    out32 = runner.main(argv())
    e16 = out16["metrics"]["GP"]["rel_L2"]
    e32 = out32["metrics"]["GP"]["rel_L2"]
    assert e16 != e32 and abs(e16 - e32) < 0.25 * max(e32, 1e-3), (e16, e32)
    assert np.isfinite(out16["metrics"]["SCaSML"]["rel_L2"])
