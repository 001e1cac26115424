"""Model layers the sparse decode path uses, in plain PyTorch ops that
mirror ``src/repro/models/layers.py``: RMSNorm, dense projections, RoPE,
decode / chunked-prefill attention with the un-repeated GQA contraction
and float32 softmax, and the gated MLP.

Conventions as the reference: activations x (B, S, D); q (B, S, H, hd);
k/v (B, S, KV, hd); statistics and attention accumulate in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import epilogue_act

__all__ = ["rms_norm", "dense", "rope_angles", "apply_rope",
           "attention_decode", "attention_prefill", "act_fn", "mlp_gated",
           "mlp_relu2"]

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None
          ) -> torch.Tensor:
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> cos/sin of shape (..., head_dim//2), float32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
            ) -> torch.Tensor:
    """x (..., S, H, hd); cos/sin (..., S, hd//2) -> rotated x (half
    style)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[..., None, :]                     # broadcast over heads
    sin = sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(q, k, positions, theta: float = 1e4):
    """Standard RoPE. positions: (B, S)."""
    cos, sin = rope_angles(positions, q.shape[-1], theta)
    return _rotate(q, cos, sin), _rotate(k, cos, sin)


def _attend(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            visible: torch.Tensor, k_scale: torch.Tensor | None = None,
            v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Shared body: q (B, C, H, hd) over caches (B, S, KV, hd) with a
    (B, C, S) visibility mask; the cache is contracted un-repeated
    against (KV, rep)-factored q, softmax in float32.  With an int8
    cache, the (B, S, KV) scales fold in exactly: q.(k*s) = (q.k)*s into
    the scores, sum_s (p*s_v).v into the probabilities."""
    b, c, h, hd = q.shape
    kvh = k_cache.shape[2]
    rep = h // kvh
    qg = q.reshape(b, c, kvh, rep, hd).float() / math.sqrt(hd)
    s = torch.einsum("bqkrd,bskd->bkrqs", qg, k_cache.float())
    if k_scale is not None:
        s = s * k_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    s = torch.where(visible[:, None, None], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bkrqs,bskd->bqkrd", p, v_cache.float())
    return out.reshape(b, c, h, hd).to(q.dtype)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Single-step decode attention: q (B, 1, H, hd) over caches
    (B, S_max, KV, hd) — bf16, or int8 with (B, S_max, KV) scales;
    entries at index >= cache_len ((B,) or scalar) are masked."""
    s_max = k_cache.shape[1]
    pos = torch.arange(s_max, device=q.device)
    lens = torch.as_tensor(cache_len, device=q.device)
    lens = lens[:, None] if lens.dim() == 1 else lens.reshape(1, 1)
    visible = (pos[None, :] < lens)[:, None, :]          # (B|1, 1, S)
    visible = visible.expand(q.shape[0], 1, s_max)
    return _attend(q, k_cache, v_cache, visible, k_scale, v_scale)


def attention_prefill(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, q_pos: torch.Tensor,
                      k_scale: torch.Tensor | None = None,
                      v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Chunked-prefill attention: q (B, C, H, hd) over caches holding the
    chunk's K/V at ``q_pos`` (B, C); key j is visible to query i iff
    j <= q_pos[i].  Scales as ``attention_decode``."""
    pos = torch.arange(k_cache.shape[1], device=q.device)
    visible = pos[None, None, :] <= q_pos[:, :, None]    # (B, C, S)
    return _attend(q, k_cache, v_cache, visible, k_scale, v_scale)


def act_fn(name: str):
    """The MLP activation; the same map as the kernels' epilogue."""
    if name not in ("silu", "gelu", "relu2", "relu"):
        raise ValueError(f"unknown activation {name!r}")
    return epilogue_act(name)


def mlp_gated(x, w_gate, w_up, w_down, activation: str = "silu"):
    """LLaMA-style gated MLP: down( act(x@gate) * (x@up) )."""
    act = act_fn(activation)
    return dense(act(dense(x, w_gate)) * dense(x, w_up), w_down)


def mlp_relu2(x, w_up, w_down, activation: str = "relu2"):
    """Non-gated MLP (squared-ReLU)."""
    return dense(act_fn(activation)(dense(x, w_up)), w_down)
