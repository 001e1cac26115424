"""Random weights from a run's seed, made on the device in a few large
calls and in the type they are served in.  A family's reference
(``reference/<family>.py``) says which leaves, shapes and spreads; the
same seed gives the same weights, which the program gets as its
parameter tree and the reference makes again after the window."""
from __future__ import annotations

import torch

__all__ = ["Draw"]


class Draw:
    """``draw(shape, std, shift=0)``: the seed's next N(shift, std^2)
    tensor on ``device`` in ``dtype``, drawn in float32."""

    def __init__(self, seed: int, device, dtype=torch.bfloat16):
        self.gen = torch.Generator(device=device).manual_seed(
            int(seed) % 2 ** 63)
        self.device, self.dtype = device, dtype

    def __call__(self, shape, std: float, shift: float = 0.0):
        t = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return t.mul_(std).add_(shift).to(self.dtype)
