"""A log-normal length, clipped: ``{"dist": "lognormal", "median",
"sigma", "min", "max"}``."""
from __future__ import annotations

import math
import statistics


def quantiles(spec: dict, n: int) -> list:
    """n evenly spaced quantiles ((i + 0.5) / n), as whole numbers."""
    dist = statistics.NormalDist(0.0, float(spec["sigma"]))
    out = []
    for i in range(n):
        v = round(float(spec["median"]) * math.exp(dist.inv_cdf((i + 0.5)
                                                                / n)))
        out.append(int(min(max(v, int(spec["min"])), int(spec["max"]))))
    return out
