"""int8 value planes, as a configuration's ``"quant": "int8"`` names them:
codes round(v / s) in [-127, 127], one absmax scale s per 128 rows of the
pack's *packed* order (``espim_pack.row_scales``); a 1-byte value and a
4-byte float32 scale per scale group."""
from __future__ import annotations

import torch

from perfbench.reference.espim_pack import row_scales

QMAX = 127
GROUP_ROWS = 128
VALUE_BYTES = 1
SCALE_BYTES = 4


def dequantize(halves: list, perm, buckets: list) -> list:
    """Each (L, rows, cols) half as its codes times their scales, float32."""
    scales = row_scales(halves, perm, buckets, QMAX, GROUP_ROWS)
    out = []
    for h, m in enumerate(halves):
        s = scales[h][:, :, None].double()
        q = torch.clamp(torch.round(m.double() / s), -QMAX, QMAX)
        out.append(q.float() * scales[h][:, :, None])
    return out
