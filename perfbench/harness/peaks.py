"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives: dense bf16 tensor operations a
second and memory bytes a second, from NVIDIA's data sheet (H100 SXM5,
700 W).  A card at a lower power limit runs below them; the run prints
its limit beside every share."""
from __future__ import annotations

__all__ = ["PEAKS", "peaks_of"]

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "bytes_per_s": 3.35e12},
}


def peaks_of(card: str) -> dict:
    try:
        return PEAKS[card]
    except KeyError:
        raise KeyError(f"no published peaks for card {card!r}; "
                       f"known: {sorted(PEAKS)}") from None
