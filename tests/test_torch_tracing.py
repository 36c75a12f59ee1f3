"""The port's tracing (scasml_gp_torch.utils.profiling) on the CPU.

With tracing off a span is one shared no-op and enters no
``record_function``.  With tracing on, under torch.profiler, a request's
spans nest inside its ``serve.request`` in the order the server runs them,
a /solve's recursion spans nest inside its ``serve.compute``, and a train's
spans come in the trainer's order with one ``train.newton_solve`` a Newton
step, holding a ``train.newton_lu`` for each step that fell back to LU.  The server's counters follow its bucket rows and a graph cache's
follow its calls, and every span the package opens is declared in
``SPANS``.
"""

import ast
import json
import os
import sys
import threading
import time

import pytest
import torch

import scasml_gp_torch as port
from scasml_gp_torch.picard import graphs
from scasml_gp_torch.serve import SurrogateServer
from scasml_gp_torch.utils import profiling

torch.set_num_threads(2)

PACKAGE = os.path.dirname(os.path.abspath(port.__file__))
D = 3
STEPS = 3
SERVE_ORDER = ["serve.pad", "serve.lock", "serve.copy_in", "serve.compute", "serve.fetch",
               "serve.gather"]


@pytest.fixture(scope="module")
def trained():
    eq = port.GradDependentNonlinear(n_input=D + 1)
    gp = port.GPGradDependentNonlinear(eq, port.GPConfig(gn_steps=STEPS), device="cpu")
    gp.GPsolver(*eq.generate_data(40, 10, torch.Generator().manual_seed(0)))
    return eq, gp


def _points(eq, n, seed=1):
    return eq.geometry().sample_domain(torch.Generator().manual_seed(seed), n).numpy()


def _server(eq, gp):
    return SurrogateServer(gp, port.ScaSMLFullHistory(eq, gp), buckets=(16, 64), n=2,
                           rho=None, M=2)


def _spans(fn):
    """(name, start, end) of the port's spans while ``fn()`` runs traced
    under torch.profiler, in order of start."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof, profiling.tracing():
        fn()
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name() in profiling.SPANS]
    return sorted(out, key=lambda s: s[1])


def _inside(spans, outer):
    return [s for s in spans if outer[1] <= s[1] and s[2] <= outer[2] and s != outer]


def test_tracing_off_enters_no_record_function(monkeypatch, trained):
    eq, gp = trained

    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling._tracing
    assert profiling.span("serve.pad") is profiling.span("train.newton")
    server = _server(eq, gp)
    x = _points(eq, 20)
    server.predict(x)
    server.solve(x)
    fresh = port.GPGradDependentNonlinear(eq, port.GPConfig(gn_steps=STEPS), device="cpu")
    fresh.GPsolver(gp.state.x_dom, gp.state.x_bdy)
    # the switch is what enters it
    with profiling.tracing(), pytest.raises(AssertionError, match="tracing off"):
        server.predict(x)
    assert not profiling._tracing


def test_switch_as_function_and_context():
    assert profiling.set_tracing(True) is False
    try:
        with profiling.tracing():
            assert profiling._tracing
        assert profiling._tracing  # as it was before the block
    finally:
        assert profiling.set_tracing(False) is True
    with profiling.tracing():
        assert profiling._tracing
    assert not profiling._tracing


def test_predict_spans_nest_in_order_inside_each_request(trained):
    eq, gp = trained
    server = _server(eq, gp)
    xs = [_points(eq, n, seed) for seed, n in enumerate((5, 20, 64))]
    spans = _spans(lambda: [server.predict(x) for x in xs])
    requests = [s for s in spans if s[0] == "serve.request"]
    assert len(requests) == 3
    for req in requests:
        inner = _inside(spans, req)
        assert [s[0] for s in inner] == SERVE_ORDER
        for a, b in zip(inner, inner[1:]):
            assert a[2] <= b[1]  # one after another, none inside another


def test_solve_spans_nest_inside_compute(trained):
    eq, gp = trained
    server = _server(eq, gp)
    spans = _spans(lambda: server.solve(_points(eq, 20)))
    (compute,) = [s for s in spans if s[0] == "serve.compute"]
    inner = [s[0] for s in _inside(spans, compute)]
    assert inner == ["picard.rollout", "scasml.guard", "scasml.u_hat"]
    (guard,) = [s for s in spans if s[0] == "scasml.guard"]
    assert [s[0] for s in _inside(spans, guard)] == ["scasml.u_hat"]


def test_train_spans_one_newton_solve_a_step(trained):
    eq, gp = trained
    x_dom, x_bdy = gp.state.x_dom, gp.state.x_bdy
    # the default initial point, and one far enough out that some Newton
    # matrices are indefinite and fall back to LU (train.newton_lu)
    large = 3.0 * torch.randn((3 * x_dom.shape[0],), generator=torch.Generator().manual_seed(1))
    lu_spans = 0
    for sol0 in (None, large):
        fresh = port.GPGradDependentNonlinear(eq, port.GPConfig(gn_steps=STEPS), device="cpu")
        spans = _spans(lambda: fresh.GPsolver(x_dom, x_bdy, sol0=sol0))
        top = [s[0] for s in spans if s[0] not in ("train.newton_solve", "train.newton_lu")]
        assert top == ["train.gram", "train.factor", "train.newton", "train.answer"]
        (newton,) = [s for s in spans if s[0] == "train.newton"]
        solves = [s for s in spans if s[0] == "train.newton_solve"]
        lus = [s for s in spans if s[0] == "train.newton_lu"]
        assert len(solves) == STEPS
        assert _inside(spans, newton) == sorted(solves + lus, key=lambda s: s[1])
        assert all(any(_inside([lu], solve) for solve in solves) for lu in lus)
        assert len(lus) == fresh.newton_lu_fallbacks
        lu_spans += len(lus)
    assert lu_spans > 0


def test_serve_counters_count_bucket_rows(trained):
    eq, gp = trained
    server = _server(eq, gp)
    # 5 rows in the 16 bucket; 150 rows as 64 + 64 + 22 (in the 64 bucket)
    for n in (5, 150):
        server.predict(_points(eq, n))
    st = server.stats()
    assert (st["requests"], st["rows"], st["rows_computed"]) == (2, 155, 16 + 3 * 64)


class StandIn:
    """An eager stand-in for the capture step: it runs the rollout on every
    replay."""

    def __init__(self, run, x):
        self.run, self.replays, self.pool, self.launches = run, 0, "pool", (0, {}, {})

    def replay(self, x):
        self.replays += 1
        return self.run(x)

    def close(self):
        pass


@pytest.mark.parametrize("owner", ["serve", "picard"])
def test_graph_cache_counts_by_owner(owner):
    made = []

    def capture(run, x, gen, pool):
        made.append(StandIn(run, x))
        return made[-1]

    cache = graphs.GraphCache(owner, capture)
    x = torch.ones((4, 2))
    params = object()
    spans = _spans(lambda: [cache(("k",), lambda x, gen, p: 2 * x, x, None, params)
                            for _ in range(4)])
    assert (cache.captures, cache.replays, made[0].replays) == (1, 3, 3)
    assert [s[0] for s in spans] == [f"{owner}.{k}" for k in
                                     ("eager", "capture", "replay", "replay", "replay")]


def _span_calls():
    """(file, first argument) of every call of ``span`` in the package, the
    argument a string or None where it is not a literal; and the owners of
    every ``GraphCache`` made there."""
    calls, owners = [], set()
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                name = getattr(node.func, "id", None) or getattr(node.func, "attr", None)
                first = node.args[0] if node.args else None
                literal = first.value if isinstance(first, ast.Constant) else None
                if name == "span":
                    calls.append((os.path.relpath(path, PACKAGE), literal))
                elif name == "GraphCache" and literal is not None:
                    owners.add(literal)
    return calls, owners


def test_every_span_is_declared():
    calls, owners = _span_calls()
    literal = {name for _, name in calls if name is not None}
    assert literal <= set(profiling.SPANS)
    # the one span whose name is made: the graph cache's, from its owner
    assert {f for f, name in calls if name is None} == {os.path.join("picard", "graphs.py")}
    assert owners == {"serve", "picard"}
    made = {f"{o}.{k}" for o in owners for k in ("eager", "capture", "replay")}
    assert literal | made == set(profiling.SPANS)
    assert set(profiling.SPANS.values()) == {"server", "recursion", "training"}


def test_harness_profile_traces_the_spans(tmp_path):
    with profiling.harness_profile(str(tmp_path), "h"):
        assert profiling._tracing
        with profiling.span("train.gram"):
            torch.ones(8) @ torch.ones(8)
    assert not profiling._tracing
    with open(tmp_path / "h.trace.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "train.gram" in names
    assert os.path.exists(tmp_path / "h.prof")


def test_stats_splits_lock_wait_from_service(trained):
    """A request queued behind another holder of the lock counts its wait
    in ``lock_wait_seconds`` and not in ``endpoint_seconds``."""
    eq, gp = trained
    server = _server(eq, gp)
    x = _points(eq, 5)
    server.predict(x)
    base = server.stats()
    server._lock.acquire()
    timer = threading.Timer(0.3, server._lock.release)
    timer.start()
    server.predict(x)
    timer.join(timeout=10)
    assert not timer.is_alive()
    st = server.stats()
    assert set(st["lock_wait_seconds"]) == set(st["endpoint_seconds"]) == {"predict"}
    wait = st["lock_wait_seconds"]["predict"] - base["lock_wait_seconds"]["predict"]
    service = st["endpoint_seconds"]["predict"] - base["endpoint_seconds"]["predict"]
    assert wait >= 0.25 and 0.0 < service < wait


def test_stats_service_time_holds_the_padding(monkeypatch, trained):
    """The padding, done before the lock is taken, counts in
    ``endpoint_seconds`` (service time) and not in ``lock_wait_seconds``."""
    eq, gp = trained
    server = _server(eq, gp)
    pad = server._pad

    def slow_pad(chunk):
        time.sleep(0.3)
        return pad(chunk)

    monkeypatch.setattr(server, "_pad", slow_pad)
    server.predict(_points(eq, 5))
    st = server.stats()
    assert st["endpoint_seconds"]["predict"] >= 0.25
    assert st["lock_wait_seconds"]["predict"] < 0.25


def test_concurrent_requests_lose_no_count(trained):
    """Requests from more threads than cores, with a short switch interval:
    the server's counters count every request."""
    eq, gp = trained
    server = _server(eq, gp)
    x = _points(eq, 5)
    threads, each = 16, 5
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [server.predict(x) for _ in range(each)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    n = threads * each
    st = server.stats()
    assert (st["requests"], st["rows"], st["rows_computed"]) == (n, 5 * n, 16 * n)
