"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is wanted (by default or by name) and there
    is none — the port never drops to the CPU unasked.  Under a
    ``FakeTensorMode`` (a dry run) no device is touched, so fake ``cuda``
    tensors need no card."""
    dev = torch.device("cuda" if device is None else device)
    if (dev.type == "cuda" and not torch.cuda.is_available()
            and torch._guards.detect_fake_mode() is None):
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev
