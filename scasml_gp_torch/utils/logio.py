"""Logging / artifact helpers (a copy of ``scasml_gp_tpu/utils/logio.py``).

Per-harness ``.log`` files by redirecting stdout and stderr, a wandb metric
stream that is a no-op unless enabled and importable, and a JSON dump that
turns numpy values into plain numbers."""

from __future__ import annotations

import contextlib
import json
import os
import sys
from typing import Optional


@contextlib.contextmanager
def tee_log(path: str):
    """Redirect stdout/stderr into ``path`` for the duration of the block
    (reference harnesses redirect permanently and restore at the end)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    out, err = sys.stdout, sys.stderr
    with open(path, "w") as fh:
        sys.stdout = fh
        sys.stderr = fh
        try:
            yield fh
        finally:
            sys.stdout = out
            sys.stderr = err


class MaybeWandb:
    """No-op unless wandb is installed AND enabled via config."""

    def __init__(self, enabled: bool, **init_kwargs):
        self.run = None
        if enabled:
            try:
                import wandb

                self.run = wandb.init(**init_kwargs)
                self._wandb = wandb
            except Exception:
                self.run = None

    def log(self, data: dict):
        if self.run is not None:
            self._wandb.log(data)

    def log_artifact(self, path: str, name: str, type: str = "profile"):
        """Upload a file as a wandb Artifact (reference uploads the cProfile
        dump this way, tests/SimpleUniform.py:147-149). No-op when disabled
        or when the file does not exist."""
        if self.run is None or not os.path.isfile(path):
            return
        try:
            artifact = self._wandb.Artifact(name, type=type)
            artifact.add_file(path)
            self.run.log_artifact(artifact)
        except Exception:
            pass

    def finish(self):
        if self.run is not None:
            self._wandb.finish()


def dump_json(path: str, data: dict):
    os.makedirs(os.path.dirname(path), exist_ok=True)

    def default(o):
        try:
            import numpy as np

            if isinstance(o, np.ndarray):
                return o.tolist()
            if isinstance(o, (np.floating, np.integer)):
                return o.item()
        except Exception:
            pass
        return str(o)

    with open(path, "w") as fh:
        json.dump(data, fh, indent=2, default=default)
