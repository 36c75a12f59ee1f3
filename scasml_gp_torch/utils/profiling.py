"""Per-harness profiling: a cProfile dump and a torch.profiler trace.

Port of ``harness_profile`` from ``scasml_gp_tpu/utils/profiling.py``, with a
torch.profiler Chrome trace in place of the XLA trace.
"""

from __future__ import annotations

import contextlib
import cProfile
import os
from typing import Optional

import torch


@contextlib.contextmanager
def harness_profile(profile_dir: Optional[str], tag: str):
    """Write ``<profile_dir>/<tag>.prof`` (host, cProfile) and
    ``<profile_dir>/<tag>.trace.json`` (torch.profiler: host ops, and device
    kernels when CUDA is available).  No-op when ``profile_dir`` is None."""
    if profile_dir is None:
        yield
        return
    os.makedirs(profile_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = cProfile.Profile()
    with torch.profiler.profile(activities=acts) as trace:
        prof.enable()
        try:
            yield
        finally:
            prof.disable()
            prof.dump_stats(os.path.join(profile_dir, f"{tag}.prof"))
    trace.export_chrome_trace(os.path.join(profile_dir, f"{tag}.trace.json"))
