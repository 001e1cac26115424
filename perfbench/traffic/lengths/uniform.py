"""A uniform whole length: ``{"dist": "uniform", "min", "max"}``, both
ends included."""
from __future__ import annotations

import math


def quantiles(spec: dict, n: int) -> list:
    """n evenly spaced quantiles ((i + 0.5) / n) of the whole numbers
    min..max."""
    lo, hi = int(spec["min"]), int(spec["max"])
    return [lo + min(hi - lo, math.floor((i + 0.5) / n * (hi - lo + 1)))
            for i in range(n)]
