"""Serving trained surrogates.

Port of ``scasml_gp_tpu/serve.py``:

- :func:`save_surrogate` / :func:`load_surrogate`: a checkpoint directory
  holding the GPState npz (gp/state.py) and a JSON manifest naming the
  equation, the surrogate class, its GPConfig and its other constructor
  knobs.  The layout is the JAX package's, so a checkpoint written by either
  package loads in the other;
- :class:`SurrogateServer`: batched inference in static-shape buckets.  A
  request of n rows runs in the smallest bucket >= n, padded by repeating
  its last row (pad rows are computed, never returned, and masked out of
  the variance guard's statistics); a larger request is chunked through the
  largest bucket;
- :func:`serve_http`: a stdlib HTTP front end (POST /predict, /solve,
  /gradient; GET /healthz, /stats).

    python -m scasml_gp_torch.serve <checkpoint> --warmup

On a CUDA device every (endpoint, bucket) runs as a captured CUDA graph
(picard/graphs.py), as the JAX server compiles one program per bucket: a
/solve through its solver's graphs, /predict and /gradient through the
server's own, keyed by (endpoint, bucket) within the GP's trained state.
``warmup`` captures them before the first request.

A request's stretches are spans (utils/profiling.py): ``serve.request``
around it and, inside it, ``serve.pad`` (checks and padding),
``serve.lock`` (the wait for the lock), per chunk ``serve.copy_in``,
``serve.compute`` and ``serve.fetch`` (the copy back, which waits for the
device), and ``serve.gather``.  ``stats()`` (GET /stats) reads the server's
counters: ``endpoint_seconds`` is service time (padding and compute, as
before the lock wait was split off), ``lock_wait_seconds`` the wait for the
lock behind other requests.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np
import torch

from scasml_gp_torch.config import GPConfig
from scasml_gp_torch.gp.state import GPState, load_state, save_state
from scasml_gp_torch.picard import graphs
from scasml_gp_torch.utils.profiling import span


def save_surrogate(path: str, gp) -> None:
    """Checkpoint a trained surrogate (state + manifest) into directory
    ``path``: the collocation GPs and the Cole-Hopf (HJB) and
    reaction-semigroup (Allen-Cahn) surrogates, whose manifest also records
    their non-GPConfig knobs."""
    if gp.state is None:
        raise ValueError("GP has no trained state; run GPsolver first")
    if not isinstance(gp.state, GPState):
        raise TypeError(
            f"serving supports GPState surrogates, got {type(gp.state).__name__}")
    os.makedirs(path, exist_ok=True)
    save_state(os.path.join(path, "state.npz"), gp.state)
    manifest = {
        "equation": type(gp.equation).__name__,
        "n_input": gp.equation.n_input,
        "gp_class": type(gp).__name__,
        "gp_config": dataclasses.asdict(gp.config),
    }
    extra = {k: float(getattr(gp, k)) for k in ("v_floor", "width", "fit_nugget")
             if hasattr(gp, k)}
    # The semigroup surrogates' state layout depends on the terminal
    # backend, so it is pinned; the rbf backend's width is restored so that
    # a reloaded surrogate does not select it again against absent data.
    if hasattr(gp, "terminal_backend"):
        extra["terminal_backend"] = gp.terminal_backend
        if gp.terminal_backend == "rbf":
            extra["width"] = float(gp.state.gamma[0])
    if extra:
        manifest["gp_kwargs"] = extra
    with open(os.path.join(path, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=2)


def load_surrogate(path: str, precision=None, device=None, mesh=None):
    """The surrogate saved at ``path`` (by either package), on ``device``
    (by default the card).  The GP carries ``mesh`` (parallel/mesh.py): its
    posterior splits the training rows over the 'model' axis, so every rank
    of the mesh must serve the same requests."""
    # the registries live beside the CLI; imported here to avoid a cycle
    from scasml_gp_torch.equations import EQUATIONS
    from scasml_gp_torch.harness.runner import GP_CLASSES

    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    eq = EQUATIONS[manifest["equation"]](n_input=manifest["n_input"])
    cls = GP_CLASSES[manifest["equation"]]
    if "gp_class" in manifest and manifest["gp_class"] != cls.__name__:
        raise ValueError(
            f"checkpoint was saved from {manifest['gp_class']}, but "
            f"{manifest['equation']} maps to {cls.__name__}")
    gp = cls(eq, GPConfig(**manifest["gp_config"]), precision=precision,
             device=device, mesh=mesh, **manifest.get("gp_kwargs", {}))
    gp.state = load_state(os.path.join(path, "state.npz"), device=gp.device)
    return gp


class SurrogateServer:
    """Bucketed batch inference over a trained GP (and an optional ScaSML
    solver for /solve).

    ``buckets`` are the batch sizes requests run at.  Endpoint bodies are
    serialised by a lock: the counters and the solver's generator are shared
    by concurrent HTTP requests.  ``deterministic`` (the default) reseeds
    the solver's generator with ``solve_seed`` before each chunk of a
    /solve, so a response depends only on its payload.  The variance
    guard's lambda is a statistic over each chunk's real rows, so a guarded
    solve chunked through smaller buckets can differ from one u_solve of
    the whole batch."""

    def __init__(self, gp, scasml=None, buckets: Sequence[int] = (256, 1024, 4096),
                 n: int = 2, rho: Optional[int] = 2, M: int = 3,
                 deterministic: bool = True, solve_seed: int = 0):
        if gp.state is None:
            raise ValueError("GP has no trained state")
        self.gp = gp
        self.scasml = scasml
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets:
            raise ValueError("need at least one bucket size")
        self.n, self.rho, self.M = n, rho, M
        self.deterministic = deterministic
        self.solve_seed = int(solve_seed)
        self.requests = 0
        self.rows = 0
        self.rows_computed = 0  # bucket rows, padding included
        self.endpoint_seconds = {}   # service time: padding and compute
        self.lock_wait_seconds = {}  # the wait for the lock
        self._lock = threading.Lock()
        # /predict and /gradient captured per (endpoint, bucket) on the card
        self._graphs = graphs.GraphCache("serve")

    def _pad(self, chunk: np.ndarray):
        """(chunk padded to its bucket by repeating its last row, real rows,
        bucket)."""
        real = chunk.shape[0]
        bucket = next(b for b in self.buckets if b >= real)
        if bucket > real:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], bucket - real, axis=0)])
        return chunk, real, bucket

    def _run_bucketed(self, endpoint, fn, x, out_cols):
        with span("serve.request"):
            with span("serve.pad"):
                x = np.asarray(x, np.float32)
                if x.ndim != 2 or x.shape[1] != self.gp.n_input:
                    raise ValueError(f"expected (n, {self.gp.n_input}) points, got {x.shape}")
                t_pad = time.perf_counter()
                n = x.shape[0]
                cap = self.buckets[-1]
                chunks = [self._pad(x[start:start + cap]) for start in range(0, n, cap)]
            outs = [np.zeros((0, out_cols), np.float32)]  # an empty request
            t_wait = time.perf_counter()
            with span("serve.lock"):
                self._lock.acquire()
            try:
                t0 = time.perf_counter()
                for chunk, real, bucket in chunks:
                    with span("serve.copy_in"):
                        xt = torch.as_tensor(chunk, device=self.gp.device)
                    with span("serve.compute"):
                        y = fn(xt, real)
                    with span("serve.fetch"):
                        outs.append(y.detach().cpu().numpy().reshape(bucket, -1)[:real])
                with span("serve.gather"):
                    out = np.concatenate(outs, axis=0)[:n, :out_cols]
                self.requests += 1
                self.rows += n
                self.rows_computed += sum(bucket for _, _, bucket in chunks)
                self.lock_wait_seconds[endpoint] = (
                    self.lock_wait_seconds.get(endpoint, 0.0) + t0 - t_wait)
                self.endpoint_seconds[endpoint] = (
                    self.endpoint_seconds.get(endpoint, 0.0)
                    + t_wait - t_pad + time.perf_counter() - t0)
            finally:
                self._lock.release()
        return out

    def _posterior(self, endpoint, fn):
        """``fn(chunk)`` for ``_run_bucketed``, through the captured graphs
        where the GP's posterior can be captured."""
        gp = self.gp

        def run(chunk, real):
            if graphs.eager_reason(chunk.device, meshes=(gp.mesh,), parity=gp.parity):
                return fn(chunk)
            return self._graphs((endpoint,), lambda c, gen, state: fn(c), chunk,
                                None, gp.state)

        return run

    def predict(self, x) -> np.ndarray:
        """GP posterior mean, (n, 1)."""
        return self._run_bucketed("predict", self._posterior("predict", self.gp.predict),
                                  x, 1)

    def gradient(self, x) -> np.ndarray:
        """GP posterior space-time gradient, (n, d+1)."""
        return self._run_bucketed(
            "gradient", self._posterior("gradient", self.gp.compute_gradient), x,
            self.gp.n_input)

    def solve(self, x) -> np.ndarray:
        """ScaSML solve (the GP plus its Picard correction), (n, 1)."""
        if self.scasml is None:
            raise ValueError("server constructed without a ScaSML solver")

        def run(chunk, real):
            if self.deterministic:
                self.scasml.gen.manual_seed(self.solve_seed)
            if self.rho is not None:
                return self.scasml.u_solve(self.n, self.rho, chunk, num_valid=real)
            return self.scasml.u_solve(self.n, None, chunk, M=self.M, num_valid=real)

        return self._run_bucketed("solve", run, x, 1)

    def warmup(self, endpoints=("predict",)) -> None:
        """Requests of every bucket on each of ``endpoints``: one on the
        CPU; two on the card, where the first fills the caches and the
        second captures the (endpoint, bucket) graphs."""
        calls = 2 if self.gp.device.type == "cuda" else 1
        for b in self.buckets:
            x = np.zeros((b, self.gp.n_input), np.float32)
            x[:, -1] = self.gp.T
            for ep in endpoints:
                for _ in range(calls):
                    getattr(self, ep)(x)

    def stats(self) -> dict:
        return {
            "requests": self.requests,
            "rows": self.rows,
            "buckets": list(self.buckets),
            "rows_computed": self.rows_computed,
            "endpoint_seconds": dict(self.endpoint_seconds),
            "lock_wait_seconds": dict(self.lock_wait_seconds),
            "captures": self._graphs.captures,
            "replays": self._graphs.replays,
        }


def serve_http(server: SurrogateServer, host: str = "127.0.0.1", port: int = 8080):
    """Expose ``server`` over HTTP (stdlib only).

    POST /predict | /solve | /gradient with body {"points": [[...], ...]}
    -> {"values": [[...], ...]}; GET /healthz -> {"ok": true}; GET /stats.
    Returns the ThreadingHTTPServer, serving on a daemon thread; the caller
    shuts it down."""

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # no stderr line per request
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            elif self.path == "/stats":
                self._reply(200, server.stats())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            fn = {"/predict": server.predict, "/solve": server.solve,
                  "/gradient": server.gradient}.get(self.path)
            if fn is None:
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                values = fn(np.asarray(payload["points"], np.float32))
            except Exception as exc:  # a bad request is the client's: report it
                self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
                return
            self._reply(200, {"values": values.tolist()})

    httpd = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def main(argv=None):
    """Serve a checkpoint directory over HTTP."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("checkpoint", help="save_surrogate directory")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--buckets", type=int, nargs="+", default=[256, 1024, 4096])
    ap.add_argument("--warmup", action="store_true")
    ap.add_argument("--solver", default="full_history",
                    choices=["none", "quadrature", "full_history"],
                    help="the ScaSML solver behind /solve ('none' serves "
                         "predict and gradient only)")
    ap.add_argument("--n", type=int, default=2, help="Picard depth")
    ap.add_argument("--rho", type=int, default=2, help="quadrature refinement level")
    ap.add_argument("--M", type=int, default=3, help="full-history sample base")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; a missing card is an error)")
    args = ap.parse_args(argv)

    gp = load_surrogate(args.checkpoint, device=args.device)
    scasml = None
    rho = args.rho
    if args.solver != "none":
        from scasml_gp_torch.picard.scasml import ScaSML, ScaSMLFullHistory

        if args.solver == "full_history":
            scasml = ScaSMLFullHistory(gp.equation, gp)
            rho = None
        else:
            scasml = ScaSML(gp.equation, gp)
    server = SurrogateServer(gp, scasml, buckets=args.buckets, n=args.n, rho=rho,
                             M=args.M)
    if args.warmup:
        server.warmup()
    httpd = serve_http(server, args.host, args.port)
    print(f"serving {args.checkpoint} on http://{args.host}:{args.port}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        httpd.shutdown()
        httpd.server_close()


if __name__ == "__main__":
    main()
