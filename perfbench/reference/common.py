"""Building blocks every family's reference shares, in plain PyTorch:
float32 without TF32, RMSNorm, rotate-half RoPE, the gap of a served
token below the best logit, and the codes of the lower-precision
controls."""
from __future__ import annotations

import contextlib

import torch

__all__ = ["fp32_exact", "rms", "rope", "serve_gaps", "quantize_rows_int8",
           "quantize_rows_fp8", "CONTROL_CODES"]


@contextlib.contextmanager
def fp32_exact():
    """float32 products without TF32, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """x (S, heads, hd) rotated by position (rotate-half pairing)."""
    half = x.shape[-1] // 2
    inv = theta ** -(torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = pos.double()[:, None] * inv[None, :]
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def serve_gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """By how much each token's logit lies below the best logit at its
    position: logits (T, vocab), tokens (T,) -> (T,) float32, >= 0."""
    tokens = tokens.to(logits.device).long()
    return logits.amax(dim=-1) - logits.gather(1, tokens[:, None])[:, 0]


def quantize_rows_int8(w: torch.Tensor, dim: int) -> torch.Tensor:
    """w rounded to int8 codes with one absmax scale per output channel,
    returned dequantized: the max runs over ``dim``, the input dim."""
    s = w.abs().amax(dim=dim, keepdim=True) / 127.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    return torch.clamp(torch.round(w / s), -127, 127) * s


def quantize_rows_fp8(w: torch.Tensor, dim: int) -> torch.Tensor:
    """w rounded to float8 e4m3 with one scale per output channel (its
    absmax at e4m3's largest value, 448), returned dequantized: the max
    runs over ``dim``, the input dim."""
    s = w.abs().amax(dim=dim, keepdim=True) / 448.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    return (w / s).to(torch.float8_e4m3fn).float() * s


# a control's weight code by name: (weights, input dim) -> dequantized
CONTROL_CODES = {"int8": quantize_rows_int8, "fp8": quantize_rows_fp8}
