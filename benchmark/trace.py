"""The traced part of a window: torch.profiler over the card (CUPTI) with
the benchmark's own host spans, reduced to plain lists.

The spans are ``torch.profiler.record_function`` ranges around the
benchmark's calls into the program (``request``, ``server.solve``,
``server.predict``, ``train``), so the host spans and the device's
operations share the profiler's clock.  ``reduce`` keeps, in seconds from
the traced window's start:

- ``spans``: (name, start, end) of every host span;
- ``ops``: (name, start, end) of every device operation (kernels, copies,
  sets) inside the window;
- ``window_s``: from the first span's start to the last span's end;
- ``busy_s``: the length of the union of the device operations;
- ``breakdown``: the 10 device operations with the most time, and the 10
  longest idle gaps of the device, each named by the innermost host span
  around it.
"""

from __future__ import annotations

import contextlib
from typing import List, Tuple


class Tracer:
    """Profile the window's first ``seconds`` (whole requests or trains) in
    a traced run; does nothing otherwise."""

    def __init__(self, on: bool, seconds: float):
        self.on, self.seconds = on, float(seconds)
        self.prof = None
        self.t0 = None
        self.items = 0      # requests or trains inside the traced part
        self.names = set()  # the host spans' names
        self.raw = None

    def start(self) -> None:
        """Start the profiler; the traced part is timed from its return."""
        if not self.on:
            return
        import time

        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    @property
    def active(self) -> bool:
        return self.prof is not None

    def span(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        import torch

        self.names.add(name)
        return torch.profiler.record_function(name)

    def after_item(self, now: float) -> bool:
        """Count a finished request or train; stop once the traced part is
        over, and say whether this call stopped it."""
        if self.prof is None:
            return False
        self.items += 1
        if now - self.t0 < self.seconds:
            return False
        self.stop()
        return True

    def stop(self) -> None:
        if self.prof is None:
            return
        import torch

        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.raw = _events(self.prof, self.names)
        self.prof = None


def _events(prof, names) -> dict:
    """Host spans and device operations, in ns on the profiler's clock.  A
    span's name also appears on the device's side (its annotation of the
    device's timeline), which is no operation."""
    spans, ops = [], []
    for e in prof.profiler.kineto_results.events():
        cuda = str(e.device_type()).endswith("CUDA")
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.name() in names:
            if not cuda:
                spans.append((e.name(), start, end))
        elif cuda:
            ops.append((e.name(), start, end))
    return {"spans": spans, "ops": ops}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce(raw: dict, items: int) -> dict:
    """The traced window's lists and totals (module docstring)."""
    if not raw or not raw["spans"]:
        raise RuntimeError("the traced window holds no host span")
    w0 = min(s[1] for s in raw["spans"])
    w1 = max(s[2] for s in raw["spans"])
    sec = 1e-9
    spans = [(n, (a - w0) * sec, (b - w0) * sec) for n, a, b in raw["spans"]]
    ops = [(n, (max(a, w0) - w0) * sec, (min(b, w1) - w0) * sec)
           for n, a, b in raw["ops"] if b > w0 and a < w1]
    window = (w1 - w0) * sec
    busy_iv = _union([(a, b) for _, a, b in ops])
    busy = sum(b - a for a, b in busy_iv)
    by_name = {}
    for n, a, b in ops:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, prev = [], 0.0
    for a, b in busy_iv + [(window, window)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: g[0] - g[1])

    def host_at(t: float) -> str:
        inner = [s for s in spans if s[1] <= t <= s[2]]
        return min(inner, key=lambda s: s[2] - s[1])[0] if inner else "none"

    idle = [[host_at(0.5 * (a + b)), b - a] for a, b in gaps[:10]]
    return {"spans": spans, "ops": ops, "window_s": window, "busy_s": busy,
            "items": items,
            "breakdown": {"device_ops": [[n, s] for n, s in top], "idle_gaps": idle}}
