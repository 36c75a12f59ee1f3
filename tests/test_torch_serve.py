"""Port's serving layer (scasml_gp_torch.serve) on the CPU: the cases of
tests/test_serve.py but the mesh case (not ported), and checkpoints that
cross packages in both directions: one written by the JAX package's
``save_surrogate`` is served by the port, one written by the port loads in
the JAX package's ``load_surrogate``.  Both evaluate the same float32
posterior of the same state, so predictions agree to 1e-5."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import scasml_gp_torch as port  # noqa: E402
from scasml_gp_torch.gp.state import FIELDS  # noqa: E402
from scasml_gp_torch.serve import (  # noqa: E402
    SurrogateServer,
    load_surrogate,
    save_surrogate,
    serve_http,
)

torch.set_num_threads(2)

D = 4
CROSS_ATOL = 1e-5


def _sample(eq, seed, n):
    return eq.geometry().sample_domain(torch.Generator().manual_seed(seed), n)


def _data(eq, n_dom, n_bdy, seed=0):
    return eq.generate_data(n_dom, n_bdy, torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def trained_gp():
    eq = port.SineNonlinear(n_input=D + 1)
    gp = port.GPSineNonlinear(eq, port.GPConfig(gn_steps=8), device="cpu")
    gp.GPsolver(*_data(eq, 150, 40))
    return eq, gp


def test_checkpoint_round_trip(tmp_path, trained_gp):
    eq, gp = trained_gp
    path = str(tmp_path / "ckpt")
    save_surrogate(path, gp)
    gp2 = load_surrogate(path, device="cpu")
    assert type(gp2).__name__ == "GPSineNonlinear"
    assert gp2.config == gp.config
    x = _sample(eq, 1, 64)
    np.testing.assert_allclose(gp2.predict(x).numpy(), gp.predict(x).numpy(), atol=1e-6)


def test_untrained_gp_refuses_checkpoint(tmp_path):
    eq = port.SineNonlinear(n_input=D + 1)
    gp = port.GPSineNonlinear(eq, port.GPConfig(), device="cpu")
    with pytest.raises(ValueError, match="no trained state"):
        save_surrogate(str(tmp_path / "x"), gp)


def test_load_surrogate_on_a_mesh_is_not_ported(tmp_path, trained_gp):
    _, gp = trained_gp
    path = str(tmp_path / "ckpt")
    save_surrogate(path, gp)
    # once unported: a 1 x 1 mesh loads the same surrogate (a real mesh is
    # in tests/test_torch_mesh.py); a mesh that is no Mesh raises
    from scasml_gp_torch.parallel import make_mesh

    with pytest.raises(TypeError, match="Mesh"):
        load_surrogate(path, device="cpu", mesh=object())
    gp2 = load_surrogate(path, device="cpu", mesh=make_mesh(1, 1))
    assert gp2.mesh.shape == {"data": 1, "model": 1}
    x = gp.state.x_dom[:9]
    assert torch.equal(gp2.predict(x), gp.predict(x))


def test_bucketed_predict_matches_direct(trained_gp):
    eq, gp = trained_gp
    server = SurrogateServer(gp, buckets=(64, 128))
    # 33 rows padded into the 64 bucket; each row's posterior is
    # independent of the padding
    x = _sample(eq, 2, 33)
    np.testing.assert_allclose(server.predict(x.numpy()), gp.predict(x).numpy(), atol=1e-6)
    # 150 rows chunked through the 128 bucket (128 + 22 padded)
    x = _sample(eq, 3, 150)
    np.testing.assert_allclose(server.predict(x.numpy()), gp.predict(x).numpy(), atol=1e-6)
    st = server.stats()
    assert st["requests"] == 2 and st["rows"] == 183 and st["rows_computed"] == 64 + 128 + 64
    assert st["buckets"] == [64, 128] and set(st["endpoint_seconds"]) == {"predict"}
    assert set(st["lock_wait_seconds"]) == {"predict"}
    assert st["captures"] == st["replays"] == 0  # the CPU takes no graphs


def test_gradient_endpoint(trained_gp):
    eq, gp = trained_gp
    server = SurrogateServer(gp, buckets=(64,))
    x = _sample(eq, 4, 17)
    out = server.gradient(x.numpy())
    assert out.shape == (17, D + 1)
    np.testing.assert_allclose(out, gp.compute_gradient(x).numpy(), atol=1e-6)


def test_solve_endpoint(trained_gp):
    eq, gp = trained_gp
    sca = port.ScaSMLFullHistory(eq, gp)
    server = SurrogateServer(gp, sca, buckets=(64,), n=2, rho=None, M=4)
    x = _sample(eq, 5, 40)
    out = server.solve(x.numpy())
    assert out.shape == (40, 1) and np.isfinite(out).all()
    exact = eq.exact_solution(x).numpy()
    assert np.linalg.norm(out - exact) / np.linalg.norm(exact) < 0.25


def test_bad_shape_rejected(trained_gp):
    _, gp = trained_gp
    server = SurrogateServer(gp, buckets=(64,))
    with pytest.raises(ValueError, match="expected"):
        server.predict(np.zeros((4, D + 7), np.float32))


def test_http_front_end(trained_gp):
    eq, gp = trained_gp
    server = SurrogateServer(gp, buckets=(64,))
    httpd = serve_http(server, port=0)  # an ephemeral port
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.load(r) == {"ok": True}
        x = _sample(eq, 6, 9)
        req = urllib.request.Request(
            f"{base}/predict", data=json.dumps({"points": x.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            values = np.asarray(json.load(r)["values"])
        np.testing.assert_allclose(values, gp.predict(x).numpy(), atol=1e-5)
        # a malformed request gets 400 and the server stays up
        bad = urllib.request.Request(f"{base}/predict", data=b'{"points": [[1, 2]]}',
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=30)
        assert err.value.code == 400
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            assert json.load(r)["requests"] >= 1
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_hjb_cole_hopf_checkpoint_round_trip(tmp_path):
    eq = port.HJB(n_input=D + 1)
    gp = port.GPHJBColeHopf(eq, device="cpu")
    gp.GPsolver(*_data(eq, 120, 30))
    path = str(tmp_path / "hjb_ckpt")
    save_surrogate(path, gp)
    gp2 = load_surrogate(path, device="cpu")
    assert type(gp2).__name__ == "GPHJBColeHopf"
    assert gp2.width == pytest.approx(gp.width)
    x = _sample(eq, 1, 64)
    np.testing.assert_allclose(gp2.predict(x).numpy(), gp.predict(x).numpy(), atol=1e-6)
    # a reloaded surrogate serves the whole solve
    server = SurrogateServer(gp2, port.ScaSMLFullHistory(eq, gp2), buckets=(64,),
                             n=1, rho=None, M=2)
    out = server.solve(x.numpy())
    assert out.shape == (64, 1) and np.isfinite(out).all()


@pytest.mark.parametrize("backend", ["mixture", "rbf"])
def test_allen_cahn_semigroup_checkpoint_round_trip(tmp_path, backend):
    """Both terminal backends round-trip: the manifest pins the backend and
    the rbf backend's selected width."""
    eq = port.AllenCahn(n_input=D + 1)
    gp = port.GPAllenCahnSemigroup(eq, terminal_backend=backend, device="cpu")
    gp.GPsolver(*_data(eq, 120, 30))
    path = str(tmp_path / f"ac_{backend}_ckpt")
    save_surrogate(path, gp)
    gp2 = load_surrogate(path, device="cpu")
    assert type(gp2).__name__ == "GPAllenCahnSemigroup"
    assert gp2.terminal_backend == backend
    x = _sample(eq, 1, 64)
    np.testing.assert_allclose(gp2.predict(x).numpy(), gp.predict(x).numpy(), atol=1e-6)
    server = SurrogateServer(gp2, port.ScaSMLFullHistory(eq, gp2), buckets=(64,),
                             n=1, rho=None, M=2)
    out = server.solve(x.numpy())
    assert out.shape == (64, 1) and np.isfinite(out).all()


def test_empty_request(trained_gp):
    eq, gp = trained_gp
    server = SurrogateServer(gp, port.ScaSMLFullHistory(eq, gp), buckets=(64,),
                             n=1, rho=None, M=2)
    x = np.zeros((0, D + 1), np.float32)
    assert server.predict(x).shape == (0, 1)
    assert server.gradient(x).shape == (0, D + 1)
    assert server.solve(x).shape == (0, 1)


def test_concurrent_solve_matches_sequential(trained_gp):
    """Simultaneous /solve posts return the sequential results: the lock
    serialises the solver's generator and the counters, and deterministic
    mode reseeds per request."""
    eq, gp = trained_gp
    server = SurrogateServer(gp, port.ScaSMLFullHistory(eq, gp), buckets=(32,),
                             n=1, rho=None, M=2)
    batches = [_sample(eq, 11 + i, 20).numpy() for i in range(6)]
    sequential = [server.solve(b) for b in batches]
    # a repeated request is bitwise the same
    np.testing.assert_array_equal(server.solve(batches[0]), sequential[0])

    httpd = serve_http(server, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/solve"
    results = [None] * len(batches)
    errors = []

    def post(i):
        try:
            req = urllib.request.Request(
                url, data=json.dumps({"points": batches[i].tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                results[i] = np.asarray(json.load(r)["values"])
        except Exception as e:  # the test reads it below
            errors.append(e)

    try:
        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(batches))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        for res, want in zip(results, sequential):
            np.testing.assert_allclose(res, want, atol=1e-6)
        assert server.stats()["requests"] == len(batches) * 2 + 1
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_guarded_solve_pad_mask():
    """Pad rows are masked out of the variance guard's statistics: lambda of
    a padded batch with num_valid equals lambda of the real rows alone."""
    eq = port.GradDependentNonlinear(n_input=D + 1)
    gp = port.GPGradDependentNonlinear(eq, port.GPConfig(gn_steps=4), device="cpu")
    gp.GPsolver(*_data(eq, 80, 20))
    sca = port.ScaSML(eq, gp, variance_guard=True)
    x = _sample(eq, 3, 8)
    x_pad = torch.cat([x, x[-1:].repeat(24, 1)])
    # a rollout's output [u_breve, z..., var]; huge pad rows would
    # dominate an unmasked statistic
    rng = np.random.default_rng(0)
    out = np.zeros((32, 1 + D + 1), np.float32)
    out[:, 0] = rng.normal(0.0, 0.05, 32)
    out[:, -1] = 1e-4
    out[8:, 0] = 50.0
    out[8:, -1] = 1e3
    out = torch.from_numpy(out)
    sca._guarded_u(out, x_pad, num_valid=8)
    lam_masked = sca.last_lambda
    sca._guarded_u(out[:8], x)
    assert lam_masked == pytest.approx(sca.last_lambda, rel=1e-6)
    sca._guarded_u(out, x_pad)
    assert abs(sca.last_lambda - lam_masked) > 1e-3


def _jax_surrogate(kind, state):
    """The JAX package's surrogate of ``kind`` holding ``state``'s arrays."""
    from scasml_gp_tpu.config import GPConfig as JaxGPConfig
    from scasml_gp_tpu.equations import EQUATIONS as JAX_EQUATIONS
    from scasml_gp_tpu.gp.semigroup import GPAllenCahnSemigroup as JaxAC
    from scasml_gp_tpu.gp.solver import GPSineNonlinear as JaxSine
    from scasml_gp_tpu.gp.state import GPState as JaxState

    if kind == "sine":
        gp = JaxSine(JAX_EQUATIONS["SineNonlinear"](n_input=D + 1), JaxGPConfig(gn_steps=8))
    else:
        gp = JaxAC(JAX_EQUATIONS["AllenCahn"](n_input=D + 1), terminal_backend="rbf")
    gp.state = JaxState(**{k: jnp.asarray(getattr(state, k).numpy()) for k in FIELDS})
    return gp


@pytest.fixture(scope="module")
def port_surrogates(trained_gp):
    eq = port.AllenCahn(n_input=D + 1)
    ac = port.GPAllenCahnSemigroup(eq, terminal_backend="rbf", device="cpu")
    ac.GPsolver(*_data(eq, 120, 30))
    return {"sine": trained_gp[1], "allen_cahn_rbf": ac}


@pytest.mark.parametrize("kind", ["sine", "allen_cahn_rbf"])
def test_jax_checkpoint_served_by_the_port(tmp_path, port_surrogates, kind):
    from scasml_gp_tpu.serve import save_surrogate as jax_save

    gp_j = _jax_surrogate(kind, port_surrogates[kind].state)
    path = str(tmp_path / "jax_ckpt")
    jax_save(path, gp_j)
    gp = load_surrogate(path, device="cpu")
    assert type(gp).__name__ == type(gp_j).__name__
    x = _sample(gp.equation, 7, 50)
    want = np.asarray(gp_j.predict(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(SurrogateServer(gp, buckets=(64,)).predict(x.numpy()),
                               want, atol=CROSS_ATOL)


@pytest.mark.parametrize("kind", ["sine", "allen_cahn_rbf"])
def test_port_checkpoint_loads_in_jax(tmp_path, port_surrogates, kind):
    from scasml_gp_tpu.serve import load_surrogate as jax_load

    gp = port_surrogates[kind]
    path = str(tmp_path / "port_ckpt")
    save_surrogate(path, gp)
    gp_j = jax_load(path)
    assert type(gp_j).__name__ == type(gp).__name__
    assert gp_j.config.__dict__ == gp.config.__dict__
    x = _sample(gp.equation, 8, 50)
    np.testing.assert_allclose(np.asarray(gp_j.predict(jnp.asarray(x.numpy()))),
                               gp.predict(x).numpy(), atol=CROSS_ATOL)
