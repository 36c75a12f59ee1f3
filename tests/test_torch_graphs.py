"""The port's captured rollouts (scasml_gp_torch.picard.graphs) on the CPU.

A CUDA graph needs the card (tests/test_torch_cuda.py holds the graphed
rollouts bitwise to eager ones there).  Here ``GraphCache`` runs with an
eager stand-in for the capture step, so its bookkeeping is held on the CPU:
one capture per (schedule, rows, state), a new capture and the old graphs
freed when the GP's state is replaced, one entry per batch-chunk shape, the
kernel's launch counts added on every replay, and the server's (endpoint,
bucket) keys.  The solvers on the CPU take the eager path, and the
low-precision normals keep JAX's law with their constants made once on the
device.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import scasml_gp_torch as port  # noqa: E402
from scasml_gp_torch.gp import fused_posterior as fp  # noqa: E402
from scasml_gp_torch.gp.state import GPState  # noqa: E402
from scasml_gp_torch.picard import core as tcore  # noqa: E402
from scasml_gp_torch.picard import graphs  # noqa: E402
from scasml_gp_torch.serve import SurrogateServer  # noqa: E402

torch.set_num_threads(2)

D = 3
KEY_LAUNCHES = {(False, False): 2, (True, False): 1}


class StandIn:
    """An eager stand-in for ``capture_cuda``.  'Capturing' runs the rollout
    once, as a capture runs its Python (so the wrapper counts its launches),
    and leaves the generator where it was, as a capture does; a replay runs
    the rollout eagerly with the launch counters held, as a graph's replay
    adds no Python-side counts of its own."""

    def __init__(self, run, x, gen):
        state = gen.get_state() if gen is not None else None
        run(x.clone())
        if gen is not None:
            gen.set_state(state)
        self.run, self.shape = run, tuple(x.shape)
        self.pool, self.closed, self.replays = "pool", False, 0

    def replay(self, x):
        assert not self.closed and tuple(x.shape) == self.shape
        before = fp.launch_counts()
        out = self.run(x.clone())
        fp.take_launches_since(before)
        self.replays += 1
        return out.clone()

    def close(self):
        self.closed = True


def stand_in_cache(made):
    def capture(run, x, gen, pool):
        made.append(StandIn(run, x, gen))
        return made[-1]
    return graphs.GraphCache("picard", capture)


def counting_rollout(x, gen, params):
    """A rollout that 'launches' the kernel as KEY_LAUNCHES says (the
    wrapper's counting, by hand) and draws from ``gen``."""
    for key, n in KEY_LAUNCHES.items():
        for _ in range(n):
            fp.launches += 1
            fp.launches_by_flags[key] = fp.launches_by_flags.get(key, 0) + 1
    return x[:, :1] * params + torch.rand((x.shape[0], 1), generator=gen)


def test_one_capture_per_key_and_launches_on_every_replay():
    """Call 1 runs eagerly, call 2 captures and replays, call 3 replays; a
    new row count is a new key; the kernel's counts rise by one rollout's
    on every call, the capture's own counts taken back."""
    made = []
    cache = stand_in_cache(made)
    x = torch.rand((8, D + 1), generator=torch.Generator().manual_seed(0))
    gen, params = torch.Generator().manual_seed(1), torch.tensor(2.0)
    fp.reset_launches()
    for call in range(1, 4):
        cache(("k", 2), counting_rollout, x, gen, params)
        assert fp.launches == 3 * call
        assert fp.launches_by_flags == {k: v * call for k, v in KEY_LAUNCHES.items()}
    assert (cache.captures, cache.replays, len(made)) == (1, 2, 1)
    assert cache.captured_keys() == [(("k", 2), (8, D + 1), torch.float32)]
    cache(("k", 2), counting_rollout, x[:5], gen, params)
    assert cache.captures == 1  # the first call of a new shape is eager
    cache(("k", 2), counting_rollout, x[:5], gen, params)
    assert cache.captures == 2 and len(cache.captured_keys()) == 2
    assert fp.launches == 3 * 5
    fp.reset_launches()


def test_replay_equals_eager_from_one_generator_state():
    """Every call, graphed or not, draws from the generator's state at the
    call: after manual_seed(s) each one equals the eager rollout."""
    cache = stand_in_cache([])
    x = torch.rand((6, D + 1), generator=torch.Generator().manual_seed(0))
    gen, params = torch.Generator(), torch.tensor(0.5)
    want = counting_rollout(x, torch.Generator().manual_seed(9), params)
    for _ in range(4):
        gen.manual_seed(9)
        torch.testing.assert_close(cache("k", counting_rollout, x, gen, params), want,
                                   rtol=0, atol=0)
    fp.reset_launches()


@pytest.fixture(scope="module")
def trained():
    eq = port.GradDependentNonlinear(n_input=D + 1)
    gp = port.GPGradDependentNonlinear(eq, port.GPConfig(gn_steps=4), device="cpu")
    gp.GPsolver(*eq.generate_data(40, 12, torch.Generator().manual_seed(0)))
    x = eq.geometry().sample_domain(torch.Generator().manual_seed(1), 16)
    return eq, gp, x


def graphed(solver, made):
    """``solver`` with its rollouts through a stand-in cache, as on the card."""
    solver._graphs = stand_in_cache(made)
    solver.eager_reason = lambda: None
    return solver


def test_state_replacement_captures_anew_and_frees_old_graphs(trained):
    """The graphs belong to one trained state: a new GPState object (the
    tuner's judge makes one per candidate) is warmed and captured anew, and
    the old state's graphs are closed."""
    eq, gp, x = trained
    made = []
    sca = graphed(port.ScaSMLFullHistory(eq, gp, seed=3), made)
    for _ in range(3):
        sca.uz_solve(1, None, x, M=2)
    assert len(made) == 1 and sca._graphs.captures == 1
    old = gp.state
    gp.state = GPState(**{f: getattr(old, f) for f in
                          ("x_dom", "x_bdy", "right_vector", "sol", "gamma", "loss_history")})
    try:
        sca.uz_solve(1, None, x, M=2)
        assert made[0].closed and sca._graphs.captured_keys() == []
        assert sca._graphs._params is gp.state
        sca.uz_solve(1, None, x, M=2)
        assert len(made) == 2 and not made[1].closed
    finally:
        gp.state = old


def test_one_entry_per_chunk_shape(trained):
    """batch_chunk splits 16 rows into chunks of 7 (the last padded): all
    three replay one graph; a batch within one chunk is its own shape."""
    eq, _, x = trained
    made = []
    mlp = graphed(port.MLPFullHistory(eq, batch_chunk=7, device="cpu", seed=2), made)
    for _ in range(2):
        out = mlp.uz_solve(2, None, x, M=2)
    assert out.shape == (16, D + 1)
    assert mlp._graphs.captured_keys() == [((2, 2), (7, D + 1), torch.float32)]
    assert made[0].replays == 5  # the first chunk of the first call warmed up
    for _ in range(2):
        mlp.uz_solve(2, None, x[:5], M=2)
    assert [k[1] for k in mlp._graphs.captured_keys()] == [(7, D + 1), (5, D + 1)]


def test_cpu_solvers_stay_eager_with_results_unchanged(trained):
    """On the CPU no solver captures: each u_solve equals the rollout run
    directly from a generator of the same seed, call after call."""
    eq, gp, x = trained
    for cls, key, call in (
            (port.ScaSML, (2, 2), lambda s: s.uz_solve(2, 2, x)),
            (port.ScaSMLFullHistory, (2, 2), lambda s: s.uz_solve(2, None, x, M=2)),
            (port.MLPFullHistory, (2, 2), lambda s: s.uz_solve(2, None, x, M=2))):
        solver = cls(eq, gp, seed=4) if cls is not port.MLPFullHistory else cls(
            eq, device="cpu", seed=4)
        assert solver.eager_reason() == "not a CUDA device"
        ref = solver._build(key)
        gen = torch.Generator().manual_seed(4)
        for _ in range(3):
            want = ref(x, gen, solver._params())
            torch.testing.assert_close(call(solver), want, rtol=0, atol=0)
        assert solver._graphs.captures == 0 and solver._graphs.captured_keys() == []


def test_eager_paths():
    """The paths that stay eager, and the reason each gives."""
    assert graphs.eager_reason("cpu") == "not a CUDA device"
    assert graphs.eager_reason("cuda") is None
    assert "debug" in graphs.eager_reason("cuda", debug_checks=True)

    class Mesh:
        data, model = 2, 1

    assert "mesh" in graphs.eager_reason("cuda", meshes=(None, Mesh()))
    assert graphs.eager_reason("cuda", parity=True) == "a parity probe"
    assert graphs.single_rank(None) and not graphs.single_rank(Mesh())


def test_capture_error_names_the_origin():
    """A capture that fails reports the first error of the chain and the
    line of the package that called it."""
    try:
        try:
            tcore._draw(torch.randn, None, (2,), dtype=torch.float64, bogus=1)
        except TypeError as inner:
            raise RuntimeError("capture invalidated") from inner
    except RuntimeError as exc:
        first = graphs._origin(exc)
        where = graphs._where(first)
    assert isinstance(first, TypeError)
    assert where.startswith("scasml_gp_torch/picard/core.py:") and "sample(" in where


def test_server_keys_each_endpoint_and_bucket(trained, monkeypatch):
    """The server's predict and gradient go through its cache keyed by
    (endpoint, bucket) within the GP's state; their outputs are unchanged."""
    eq, gp, _ = trained
    server = SurrogateServer(gp, buckets=(4, 16))
    x = eq.geometry().sample_domain(torch.Generator().manual_seed(5), 10).numpy()
    want = server.predict(x), server.gradient(x[:3])
    assert server._graphs.captured_keys() == []  # eager on the CPU
    server._graphs = stand_in_cache([])
    monkeypatch.setattr(graphs, "eager_reason", lambda *a, **k: None)
    for _ in range(2):
        p, g = server.predict(x), server.gradient(x[:3])
    np.testing.assert_array_equal(p, want[0])
    np.testing.assert_array_equal(g, want[1])
    assert sorted(k[:2] for k in server._graphs.captured_keys()) == [
        (("gradient",), (4, D + 1)), (("predict",), (16, D + 1))]


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float16, torch.float16),
                                           (jnp.bfloat16, torch.bfloat16)],
                         ids=["float16", "bfloat16"])
def test_low_precision_constants_made_once(jdtype, tdtype):
    """_lowp_normal with its constants made once per (dtype, device) gives
    the bits of the formula that built them on every draw, on the support
    of jax.random.normal in that dtype (the law itself:
    tests/test_torch_parity.py)."""
    n = 200_000
    got = tcore._lowp_normal((n,), torch.Generator().manual_seed(0), "cpu", tdtype)
    assert tcore._lowp_constants(tdtype, torch.device("cpu")) is tcore._lowp_constants(
        tdtype, torch.device("cpu"))
    m = torch.randint(0, 2 ** tcore._MANTISSA[tdtype], (n,),
                      generator=torch.Generator().manual_seed(0))
    lo = torch.nextafter(torch.tensor(-1.0, dtype=tdtype), torch.tensor(0.0, dtype=tdtype))
    span = torch.tensor(1.0, dtype=tdtype) - lo
    u = torch.maximum((m.to(torch.float32) / 2 ** tcore._MANTISSA[tdtype]).to(tdtype)
                      * span + lo, lo)
    want = torch.erfinv(u.to(torch.float32)).to(tdtype) * torch.tensor(2.0 ** 0.5,
                                                                        dtype=tdtype)
    assert torch.equal(got, want)
    support = set(np.unique(np.asarray(
        jax.random.normal(jax.random.PRNGKey(0), (n,), jdtype), np.float64)))
    drawn = set(np.unique(got.double().numpy()))
    assert len(drawn - support) <= 1  # erfinv's rounding (test_torch_parity.py)
