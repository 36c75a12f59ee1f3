"""The port's tracing: named spans on the profiler's clock, and the
per-harness profile.

``span(name)`` marks a host-level stretch of the program.  With tracing off
(the default) it returns one shared no-op context: it calls nothing in
torch, allocates nothing and never waits for the device.  With tracing on
(``set_tracing(True)`` or ``with tracing():``) it is
``torch.profiler.record_function(name)``: under ``torch.profiler`` the span
is a host range on the clock of the device's events, and the profiler
annotates the device work launched inside it with the same name.  Spans sit
at host-level boundaries only, never inside code that a CUDA graph
captures: a span there would be recorded once, at capture, and on no
replay.  Every name is declared in ``SPANS`` with its layer.

``harness_profile`` is the port of ``harness_profile`` from
``scasml_gp_tpu/utils/profiling.py``, with a torch.profiler Chrome trace in
place of the XLA trace; the port's spans are on inside it.
"""

from __future__ import annotations

import contextlib
import cProfile
import os
from typing import Dict, Optional

import torch

# Every span of the port, by name, with its layer.
SPANS: Dict[str, str] = {
    # serve.py SurrogateServer._run_bucketed; serve.request is a request's
    # outer span, the one its other spans nest in
    "serve.request": "server",
    "serve.pad": "server",
    "serve.lock": "server",
    "serve.copy_in": "server",
    "serve.compute": "server",
    "serve.fetch": "server",
    "serve.gather": "server",
    # picard/graphs.py GraphCache.__call__, by the cache's owner
    "serve.eager": "server",
    "serve.capture": "server",
    "serve.replay": "server",
    "picard.eager": "recursion",
    "picard.capture": "recursion",
    "picard.replay": "recursion",
    # picard/mlp.py _PicardBase._run; picard/scasml.py
    "picard.rollout": "recursion",
    "scasml.guard": "recursion",
    "scasml.u_hat": "recursion",
    # gp/solver.py GPsolver, _train, _newton_body, spd_first_solve
    "train.gram": "training",
    "train.factor": "training",
    "train.newton": "training",
    "train.newton_solve": "training",
    "train.newton_lu": "training",
    "train.answer": "training",
}

_NOOP = contextlib.nullcontext()
_tracing = False


def span(name: str):
    """A context over the stretch of the program called ``name`` (a key of
    ``SPANS``)."""
    if not _tracing:
        return _NOOP
    return torch.profiler.record_function(name)


def set_tracing(on: bool) -> bool:
    """Switch the port's spans on or off; returns the previous setting."""
    global _tracing
    before, _tracing = _tracing, bool(on)
    return before


@contextlib.contextmanager
def tracing():
    """The port's spans on inside the block, as they were after it."""
    before = set_tracing(True)
    try:
        yield
    finally:
        set_tracing(before)


@contextlib.contextmanager
def harness_profile(profile_dir: Optional[str], tag: str):
    """Write ``<profile_dir>/<tag>.prof`` (host, cProfile) and
    ``<profile_dir>/<tag>.trace.json`` (torch.profiler: host ops and the
    port's spans, and device kernels when CUDA is available).  No-op when
    ``profile_dir`` is None."""
    if profile_dir is None:
        yield
        return
    os.makedirs(profile_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = cProfile.Profile()
    with torch.profiler.profile(activities=acts) as trace, tracing():
        prof.enable()
        try:
            yield
        finally:
            prof.disable()
            prof.dump_stats(os.path.join(profile_dir, f"{tag}.prof"))
    trace.export_chrome_trace(os.path.join(profile_dir, f"{tag}.trace.json"))
