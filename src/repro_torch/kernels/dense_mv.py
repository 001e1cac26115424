"""Launch wrapper of the hand-written Hopper dense MV kernel
(``csrc/dense_mv.cu``), which replaces ``dense_mv_pallas``
(``src/repro/kernels/dense_mv.py``), the Newton-analogue baseline.

``dense_mv_cuda`` takes CUDA tensors only: it checks device, dtype and
shape and calls ``torch.ops.repro_torch.dense_mv`` (``kernels/library.py``),
whose CUDA implementation allocates the output, launches on the current
stream, raises if the launch was refused, and adds one to
``LAUNCHES["dense_mv"]``; on fake tensors its Meta implementation gives
the output's shape and dtype and launches nothing.  Its
plain version is ``kernels/ref.dense_mv_ref``; ``kernels/ops.dense_mv``
picks between the two by the tensors' device.  The kernel is bound by
the bytes of W (see the source's header note).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.library import define

__all__ = ["LAUNCHES", "reset_launches", "dense_mv_cuda"]

# kernel launches since the last reset
LAUNCHES = {"dense_mv": 0}

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    r, c = w.shape
    out = torch.empty((r,), dtype=torch.float32, device=w.device)
    if r == 0:
        return out
    if c == 0:
        return out.zero_()
    # 16-byte loads need every row start, and x, 16-byte aligned
    vec = int(c * w.element_size() % 16 == 0 and w.data_ptr() % 16 == 0
              and x.data_ptr() % 16 == 0)
    rc = load_library("dense_mv").dense_mv(
        w.data_ptr(), int(w.dtype == torch.bfloat16), x.data_ptr(),
        int(x.dtype == torch.bfloat16), out.data_ptr(), r, c, vec,
        torch.cuda.current_stream(w.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dense_mv launch failed: cudaError {rc}")
    LAUNCHES["dense_mv"] += 1
    return out


_dense_mv = define(
    "dense_mv(Tensor w, Tensor x) -> Tensor", _launch,
    lambda w, x: torch.empty((w.shape[0],), dtype=torch.float32,
                             device=w.device),
    lambda w, x: 2 * w.numel())


def dense_mv_cuda(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y (R,) f32 = w (R, C) @ x (C,), w and x each f32 or bf16, summed in
    f32."""
    for name, t in (("w", w), ("x", x)):
        if not (t.is_cuda and t.device == w.device):
            raise ValueError(f"{name} must be a CUDA tensor on {w.device}, "
                             f"got {t.device}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name} must be float32 or bfloat16, got "
                             f"{t.dtype}")
    if w.dim() != 2 or tuple(x.shape) != (w.shape[1],):
        raise ValueError(f"need w (R, C) and x (C,), got {tuple(w.shape)} "
                         f"and {tuple(x.shape)}")
    if w.numel() >= 2 ** 31:
        raise ValueError("w too large for 32-bit row offsets")
    return _dense_mv(w.contiguous(), x.contiguous())
