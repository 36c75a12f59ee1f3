"""Captured rollouts: the port's counterpart of the ``jax.jit`` in the JAX
package's ``picard/mlp.py::_get_fn`` and of its server's per-bucket compile.

The JAX package traces each static Picard rollout once per schedule and
runs the compiled program on every later call.  On a CUDA device the port
does the same with a CUDA graph (:class:`GraphCache`):

1. the first call of a key runs eagerly.  It is the warm-up: it fills every
   cache the rollout reads from the host (the kernel's stacked inputs,
   ``GPState.fused_inputs``; its launch plan and the loaded library; the
   quadrature rules and the low-precision constants on the device);
2. the second call captures the rollout into one ``torch.cuda.CUDAGraph``
   and replays it;
3. every later call copies its input into the graph's static input,
   replays the graph and returns a clone of the static output, which the
   next replay overwrites.

A key is (schedule key, rows, dtype) within one ``params`` object, the
trained state the rollout evaluates.  The kernel takes the state's gamma as
host floats in its launch arguments, so a graph bakes in one state, and the
addresses of its tensors: a new ``params`` object frees every graph of the
old one, and the cache holds a reference to the object its graphs belong
to.  A cache's graphs share one memory pool.

Random numbers: the solver's generator is registered with each graph, so a
replay draws from the generator's state at replay time and advances it as an
eager call does.  From one generator state a replay and an eager call give
the same bits: after ``gen.manual_seed(s)`` (the tuner's common random
numbers, the server's deterministic reseed) a graphed call equals an eager
one.

Launch counts: capture runs the wrapper of the fused-posterior kernel
without launching it, so the counts a capture makes are taken back and the
graph's launches are counted on every replay (gp/fused_posterior.py
``take_launches_since`` / ``add_launches``).

A capture runs under ``torch.cuda.set_sync_debug_mode("error")``: an op that
would wait for the device, or copy from the host, raises
:class:`GraphCaptureError`, naming the op and the line of the port that
called it.  Nothing falls back to eager.

A cache takes its owner's name, ``serve`` (the server's /predict and
/gradient) or ``picard`` (a solver's rollouts): its calls are the spans
``<owner>.eager``, ``<owner>.capture`` and ``<owner>.replay``
(utils/profiling.py).

These paths stay eager (``eager_reason``): CPU tensors; ``--debug-checks``
(utils/debug.py checks every op's output on the host); a mesh with more
than one rank on its 'data' or 'model' axis (the rollout's gather and the
posterior's all-reduce are collectives); and the parity probes
(``terminal_crn`` makes a generator inside each terminal pass,
``reference_semantics`` comes with it, and the GP's parity modes copy their
subset indices from the host on every call).
"""

from __future__ import annotations

import gc
import os
import traceback
from typing import Callable, Optional

import torch

from scasml_gp_torch.gp import fused_posterior as fp
from scasml_gp_torch.utils.profiling import span

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TORCH = os.path.dirname(os.path.abspath(torch.__file__))
_WARM = "warm"  # a key whose eager warm-up call has run


class GraphCaptureError(RuntimeError):
    """A rollout could not be captured as a CUDA graph."""


def single_rank(mesh) -> bool:
    """Whether ``mesh`` (parallel/mesh.py, or None) has one rank on each axis."""
    return mesh is None or mesh.data * mesh.model == 1


def eager_reason(device, debug_checks=False, meshes=(), parity=False) -> Optional[str]:
    """Why a rollout on ``device`` runs eagerly, or None when it is graphed."""
    if torch.device(device).type != "cuda":
        return "not a CUDA device"
    if debug_checks:
        return "--debug-checks checks every op on the host"
    if not all(single_rank(m) for m in meshes):
        return "a mesh of more than one rank runs collectives"
    if parity:
        return "a parity probe"
    return None


class Captured:
    """One captured graph with its static inputs and output."""

    def __init__(self, graph, static_in: tuple, static_out):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.launches = (0, {}, {})  # the kernel launches of one replay
        self.pool = graph.pool()

    def replay(self, *xs: torch.Tensor):
        """Copy ``xs`` into the static inputs, replay, and return a clone of
        the static output (None for a graph that returns nothing)."""
        for static, x in zip(self.static_in, xs, strict=True):
            static.copy_(x)
        self.graph.replay()
        return None if self.static_out is None else self.static_out.clone()

    def close(self) -> None:
        self.graph.reset()
        self.static_in = self.static_out = None


def _origin(exc: BaseException) -> BaseException:
    """The first exception of the chain that ``exc`` ended."""
    while exc.__context__ is not None:
        exc = exc.__context__
    return exc


def _where(exc: BaseException) -> str:
    """file:line and source of the innermost frame that ``exc`` passed
    through outside torch and this module: the line that called the op."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if not f.filename.startswith(_TORCH) and f.filename != __file__]
    if not frames:
        return "an op of torch"
    f = frames[-1]
    name = f.filename
    if name.startswith(_PACKAGE):
        name = os.path.relpath(name, os.path.dirname(_PACKAGE))
    return f"{name}:{f.lineno}: {f.line}"


def capture_cuda(run: Callable, x: torch.Tensor, gen, pool) -> Captured:
    """Capture the rollout ``run(static_x)`` as one CUDA graph (the capture
    step of :class:`GraphCache`); see :func:`capture_graph`."""
    return capture_graph(run, (x,), gen, pool, "the rollout")


def capture_graph(run: Callable, inputs: tuple = (), gen=None, pool=None,
                  what: str = "the rollout") -> Captured:
    """Capture ``run(*static_inputs)`` as one CUDA graph on a side stream,
    the static inputs cloned from ``inputs`` (a function that reads and
    writes buffers of its own takes none), with ``gen`` (a CUDA
    torch.Generator, or None) registered with it and its memory in ``pool``
    (None: a new pool).  ``run`` may differentiate: the backward ops run on
    the stream of their forward ops, the capture's.  Host syncs and host
    copies raise :class:`GraphCaptureError` naming the op and ``what`` was
    being captured."""
    graph = torch.cuda.CUDAGraph()
    if gen is not None:
        graph.register_generator_state(gen)
    static_in = tuple(x.clone() for x in inputs)
    dev = inputs[0].device if inputs else torch.device("cuda", torch.cuda.current_device())
    current = torch.cuda.current_stream(dev)
    stream = torch.cuda.Stream(device=dev)
    stream.wait_stream(current)
    mode = torch.cuda.get_sync_debug_mode()
    # The cyclic garbage collector stays off during the capture: collecting
    # another graph destroys it, a call that invalidates the capture.
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                torch.cuda.set_sync_debug_mode("error")
                static_out = run(*static_in)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
                graph.capture_end()
    except BaseException as exc:
        graph.reset()  # here, not whenever the traceback is collected
        if not isinstance(exc, RuntimeError):
            raise
        first = _origin(exc)
        raise GraphCaptureError(
            f"{what} cannot be captured as a CUDA graph: at {_where(first)}: "
            f"{type(first).__name__}: {first}") from exc
    finally:
        if collecting:
            gc.enable()
        current.wait_stream(stream)
    return Captured(graph, static_in, static_out)


class GraphCache:
    """Captured rollouts of one solver, or of the server, by (key, rows,
    dtype) within one ``params`` object (module docstring).  ``owner``
    (``serve`` or ``picard``, declared in ``SPANS``) names its spans.
    ``capture(run, x, gen, pool)`` captures ``run`` at input ``x`` and
    returns an object with ``replay(x)``, ``close()``, ``pool`` and a
    ``launches`` slot; it is ``capture_cuda`` on the card, and the CPU
    tests give an eager stand-in."""

    def __init__(self, owner: str, capture: Callable = capture_cuda):
        self._names = {k: f"{owner}.{k}" for k in ("eager", "capture", "replay")}
        self._capture = capture
        self._entries = {}
        self._params = None
        self._pool = None
        self.captures = 0
        self.replays = 0

    def __call__(self, key, fn: Callable, x: torch.Tensor, gen, params) -> torch.Tensor:
        """``fn(x, gen, params)``: eager on a key's first call, captured on
        its second, replayed from then on."""
        if params is not self._params:
            self.clear()
            self._params = params
        k = (key, tuple(x.shape), x.dtype)
        entry = self._entries.get(k)
        if entry is None:
            self._entries[k] = _WARM
            with span(self._names["eager"]):
                return fn(x, gen, params)
        if entry is _WARM:
            with span(self._names["capture"]):
                before = fp.launch_counts()
                try:
                    entry = self._capture(lambda xs: fn(xs, gen, params), x, gen, self._pool)
                finally:
                    launches = fp.take_launches_since(before)
            entry.launches = launches
            if self._pool is None:
                self._pool = entry.pool
            self._entries[k] = entry
            self.captures += 1
        with span(self._names["replay"]):
            out = entry.replay(x)
        fp.add_launches(entry.launches)
        self.replays += 1
        return out

    def captured_keys(self) -> list:
        """The (key, rows, dtype) of every captured graph."""
        return [k for k, e in self._entries.items() if e is not _WARM]

    def launches_by_key(self) -> dict:
        """The kernel launches of one replay of each captured graph."""
        return {k: e.launches[0] for k, e in self._entries.items() if e is not _WARM}

    def clear(self) -> None:
        """Free every graph and forget the keys and the params object."""
        for entry in self._entries.values():
            if entry is not _WARM:
                entry.close()
        self._entries.clear()
        self._params = None
        self._pool = None
