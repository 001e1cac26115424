"""Flash attention: the launch wrapper of the hand-written Hopper kernel
(``csrc/flash_attention.cu``), which replaces ``flash_attention_pallas``
(``src/repro/kernels/flash_attention.py``), and ``flash_attention``, which
dispatches between it and its plain version as ``kernels/ops`` does.

Layout as in the reference: q, k, v ``(BH, S, hd)``, float32 or bfloat16,
output in q's dtype; GQA repeats and ``(B, S, H, hd)`` reshapes live in
the caller.  ``flash_attention_cuda`` takes CUDA tensors only, checks
them and calls ``torch.ops.repro_torch.flash_attention``
(``kernels/library.py``), whose CUDA implementation allocates the
output, launches on the current stream, raises if the launch was
refused, and adds one to ``LAUNCHES["flash_attention"]``; on fake
tensors its Meta implementation gives the output's shape and dtype and
launches nothing.
bf16 inputs run on the tensor cores (the wgmma + TMA body), fp32 inputs
on the fp32 body: dispatch by dtype inside the C entry point (see the
source's header note).  The kernel is built for hd in ``HEAD_DIMS``; a
narrower head is zero-padded up to the next of them (``pad_heads``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.build import load_library
from repro_torch.kernels.library import define
from repro_torch.kernels.ops import _resolve, _use_kernel

__all__ = ["LAUNCHES", "reset_launches", "HEAD_DIMS", "pad_heads",
           "flash_attention_cuda", "flash_attention"]

# kernel launches since the last reset
LAUNCHES = {"flash_attention": 0}

HEAD_DIMS = (32, 64, 128)       # the head widths the kernel is built for


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pad_heads(attend, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> torch.Tensor:
    """``attend(q, k, v, causal, scale)`` at the head width the kernel is
    built for: q, k and v zero-padded along hd up to the next width in
    ``HEAD_DIMS``, the softmax scale that of the true hd (1 / sqrt(hd)),
    the output sliced back to hd.  Zero columns add nothing to q·k or to
    P·V, so the result is attention at hd.  Raises for hd above the
    widest built width."""
    hd = q.shape[-1]
    width = next((w for w in HEAD_DIMS if hd <= w), None)
    if width is None:
        raise ValueError(f"head width {hd} is not supported: the kernel is "
                         f"built for hd in {HEAD_DIMS} and zero-pads a "
                         f"narrower head up to the next of them")
    scale = 1.0 / math.sqrt(hd)
    if width == hd:
        return attend(q, k, v, causal, scale)
    q, k, v = (F.pad(t, (0, width - hd)) for t in (q, k, v))
    return attend(q, k, v, causal, scale)[..., :hd].contiguous()


def _kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: float) -> torch.Tensor:
    bh, s, hd = q.shape
    out = torch.empty_like(q)
    if bh == 0 or s == 0:
        return out
    rc = load_library("flash_attention").flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), bh, s, hd, int(causal), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:     # a cudaError_t; 900: no tensor-map encoder; 1000 +
        # a CUresult: the CUDA driver refused a tensor map
        raise RuntimeError(f"flash_attention launch failed: rc {rc}")
    LAUNCHES["flash_attention"] += 1
    return out


def _pairs(s: int, causal: bool) -> int:
    """(query, key) pairs the softmax visits."""
    return s * (s + 1) // 2 if causal else s * s


_flash = define(
    "flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
    "float scale) -> Tensor", _kernel,
    lambda q, k, v, causal, scale: torch.empty_like(q),
    lambda q, k, v, causal, scale: (4 * q.shape[0] * q.shape[2]
                                    * _pairs(q.shape[1], causal)))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: float) -> torch.Tensor:
    """One kernel launch on contiguous (BH, S, hd) tensors, hd built.
    Raises for an input that requires grad under grad mode: the kernel
    writes through raw pointers, so its output would carry no
    ``grad_fn`` and cut the graph silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention kernel has no backward: call it "
                           "under torch.no_grad() or on tensors that do not "
                           "require grad")
    if q.numel() >= 2 ** 31:
        raise ValueError("q too large for 32-bit offsets")
    return _flash(q, k, v, bool(causal), float(scale))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """Online-softmax attention over (BH, S, hd) -> (BH, S, hd) in q's
    dtype; keys after the query are masked when ``causal``.  Any hd up to
    128: a head narrower than a built width is zero-padded up to it
    (``pad_heads``), which costs one copy of q, k and v and the products
    of the padded width (1.6x at hd = 80, padded to 128)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not (t.is_cuda and t.device == q.device):
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")
        if t.dtype != q.dtype or tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"q, k, v must share dtype and shape; {name} is "
                             f"{t.dtype}{tuple(t.shape)}, q "
                             f"{q.dtype}{tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3 or q.shape[2] < 1:
        raise ValueError(f"need (BH, S, hd), got {tuple(q.shape)}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    return pad_heads(_launch, q, k, v, causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, impl: str | None = None
                    ) -> torch.Tensor:
    """(BH, S, hd) attention: the kernel for CUDA tensors (``impl=None``
    or ``"cuda"``), the plain masked softmax for CPU tensors or
    ``impl="ref"``."""
    if _use_kernel(_resolve(impl), q, k, v):
        return flash_attention_cuda(q, k, v, causal=causal)
    return _ref.flash_attention_ref(q, k, v, causal)
