"""NaN checks for debug runs (``--debug-checks``).

The JAX package wraps each compiled rollout in checkify's float checks
(``scasml_gp_tpu/picard/mlp.py``): the first primitive whose output holds a
NaN raises, and the error names it.  Here :class:`FloatChecks`, a
``TorchDispatchMode``, does the same for every aten op run under it: the
first floating output holding a NaN raises :class:`FloatCheckError` naming
the op.  Only NaN raises, as checkify's nan check: an inf does not.  Each op
costs one host sync while the mode is on, in debug runs only.

Work the mode cannot see, such as a CUDA kernel launched through ctypes,
checks its own outputs with :func:`check` where :func:`active` says a mode
is on (``gp/fused_posterior.py``).
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)
from torch.utils._pytree import tree_leaves

# Ops whose output is uninitialised memory until something writes it.
_UNINITIALISED = frozenset(
    ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"))


class FloatCheckError(RuntimeError):
    """A floating tensor made under :class:`FloatChecks` holds a NaN."""


def check(name: str, *outputs) -> None:
    """Raise FloatCheckError if a floating tensor among ``outputs`` (nested
    in tuples, lists or dicts; others are skipped) holds a NaN."""
    for t in tree_leaves(outputs):
        if (isinstance(t, torch.Tensor) and t.is_floating_point()
                and bool(torch.isnan(t).any())):
            raise FloatCheckError(f"nan generated by {name}")


class FloatChecks(TorchDispatchMode):
    """Check every floating output of every aten op for NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNINITIALISED:
            check(f"aten op {func}", out)
        return out


def active() -> bool:
    """Whether a FloatChecks mode is on in this thread."""
    return any(isinstance(m, FloatChecks) for m in _get_current_dispatch_mode_stack())


def float_checked(fn):
    """``fn`` run under FloatChecks."""

    @functools.wraps(fn)
    def checked(*args, **kwargs):
        with FloatChecks():
            return fn(*args, **kwargs)

    return checked
