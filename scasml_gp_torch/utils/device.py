"""The device the port's constructors and entry points run on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card (``cuda``).
    Asking for CUDA where ``torch.cuda.is_available()`` is false raises:
    nothing falls back to the CPU unless the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for (the default) but torch.cuda.is_available() "
            "is false; pass device='cpu' (--device cpu) to run on the CPU"
        )
    return dev
