"""Model layers, in plain PyTorch ops that mirror
``src/repro/models/layers.py``: RMSNorm and LayerNorm, dense projections,
RoPE and Qwen2-VL's M-RoPE, full-sequence attention (``flash_attention``:
kernel 8 on the card for inference, a chunked online softmax otherwise
and whenever autograd records), decode /
chunked-prefill attention with the un-repeated GQA contraction and
float32 softmax (and, over a sequence split across ranks, each rank's
partial softmax combined by all-reduces), and the MLPs.

Conventions as the reference: activations x (B, S, D); q (B, S, H, hd);
k/v (B, S, KV, hd); statistics and attention accumulate in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.ops import _resolve, _use_kernel
from repro_torch.kernels.ref import epilogue_act

__all__ = ["shard_hint", "rms_norm", "layer_norm", "dense", "rope_angles",
           "apply_rope", "apply_mrope", "repeat_kv", "flash_attention",
           "attention_decode", "attention_prefill", "act_fn", "mlp_gated",
           "mlp_relu2"]

NEG_INF = -1e30


def shard_hint(x: torch.Tensor, *logical) -> torch.Tensor:
    """The identity.  The reference's hint pins a loop-carried activation
    to the ambient mesh so that XLA's sharding propagation does not
    replicate it; eager PyTorch has no propagation to re-anchor.  The
    port's forwards run on plain tensors: on a mesh, the dense family's
    sharded steps pass each rank's local shards and reshard explicitly
    (``partition.fsdp_gather`` per layer, ``copy_to`` / ``reduce_from``
    around the tensor-parallel products, ``gather_dim`` where a model
    shard holds no whole head: ``models.transformer.forward_sharded``),
    and the other families' steps gather their params first.  Kept so
    that code written against the reference's layers reads the same;
    ``logical`` is ignored."""
    return x


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


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


def apply_mrope(q, k, positions3, theta: float, sections=(16, 24, 24)):
    """Qwen2-VL multimodal RoPE: the rotary half-dim is split into
    (temporal, height, width) sections, each driven by its own position
    id.  positions3: (3, B, S).  Sections that do not sum to hd/2 (the
    default fits hd 128) are derived in proportion, 2:3:3 eighths, the
    last taking the remainder."""
    half = q.shape[-1] // 2
    if sum(sections) != half:
        base = half // 8
        sections = (2 * base, 3 * base, half - 5 * base)
    cos_parts, sin_parts, lo = [], [], 0
    for i, width in enumerate(sections):
        exps = torch.arange(lo, lo + width, dtype=torch.float32,
                            device=q.device) / half
        freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                             device=q.device), exps)
        ang = positions3[i].float()[..., None] * freqs
        cos_parts.append(torch.cos(ang))
        sin_parts.append(torch.sin(ang))
        lo += width
    cos = torch.cat(cos_parts, dim=-1)
    sin = torch.cat(sin_parts, dim=-1)
    return _rotate(q, cos, sin), _rotate(k, cos, sin)


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV * n_rep, hd), each head repeated."""
    if n_rep == 1:
        return k
    b, s, kv, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, d).reshape(
        b, s, kv * n_rep, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """Full-sequence attention: q (B, Sq, H, hd); k/v (B, Skv, KV, hd)
    with H % KV == 0 -> (B, Sq, H, hd) in q's dtype.  ``causal`` aligns
    the ends of the two sequences.

    Dispatch by shape and grad state: with Sq == Skv (the shape set of
    ``flash_attention_pallas``), hd up to the widest built width
    (``FA.HEAD_DIMS``), CUDA tensors and nothing to differentiate, k and
    v are repeated to H heads, the heads folded into (B·H, S, hd) and
    kernel 8 launched; any failure of the kernel raises.  Otherwise (the
    CPU, the ``ESPIM_IMPL=ref`` pin, unequal lengths: Whisper's
    teacher-forced cross-attention, a wider head, or grad mode on with q,
    k or v requiring grad: training) the chunked online softmax of the
    reference runs (``_flash_chunked``).  Kernel 8 has no backward, and
    the reference differentiates this same chunked softmax."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    k = repeat_kv(k, h // kvh)
    v = repeat_kv(v, h // kvh)
    if (sq == skv and hd <= FA.HEAD_DIMS[-1] and not _needs_grad(q, k, v)
            and _use_kernel(_resolve(None), q, k, v)):
        def fold(t):
            return t.transpose(1, 2).reshape(b * h, sq, hd)
        out = FA.flash_attention_cuda(fold(q), fold(k), fold(v),
                                      causal=causal)
        return out.reshape(b, h, sq, hd).transpose(1, 2)
    return _flash_chunked(q, k, v, causal, q_chunk, kv_chunk)


def _needs_grad(*tensors) -> bool:
    """True when autograd would record an op on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _flash_chunked(q, k, v, causal: bool, q_chunk: int, kv_chunk: int
                   ) -> torch.Tensor:
    """The reference's online softmax over (q chunk, kv chunk) blocks on
    repeated heads: operands at the model dtype (q pre-scaled and cast
    back), scores and accumulators in float32, kv padding masked, the
    causal mask offset by Skv - Sq."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, skv)
    n_q, n_kv = -(-sq // q_chunk), -(-skv // kv_chunk)
    qt = F.pad(q, (0, 0, 0, 0, 0, n_q * q_chunk - sq)).transpose(1, 2)
    kt = F.pad(k, (0, 0, 0, 0, 0, n_kv * kv_chunk - skv)).transpose(1, 2)
    vt = F.pad(v, (0, 0, 0, 0, 0, n_kv * kv_chunk - skv)).transpose(1, 2)
    offset = skv - sq
    dev = q.device
    blocks = []
    for qi in range(n_q):
        qb = qt[:, :, qi * q_chunk:(qi + 1) * q_chunk]
        qb = (qb.float() * scale).to(q.dtype).float()
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((b, h, q_chunk), NEG_INF, device=dev)
        l_sum = torch.zeros((b, h, q_chunk), device=dev)
        acc = torch.zeros((b, h, q_chunk, hd), device=dev)
        for ki in range(n_kv):
            kb = kt[:, :, ki * kv_chunk:(ki + 1) * kv_chunk].float()
            vb = vt[:, :, ki * kv_chunk:(ki + 1) * kv_chunk].float()
            s_ = qb @ kb.transpose(-1, -2)
            kv_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            mask = (kv_pos < skv)[None, :]
            if causal:
                mask = mask & (q_pos[:, None] + offset >= kv_pos[None, :])
            s_ = torch.where(mask, s_, torch.full_like(s_, NEG_INF))
            m_new = torch.maximum(m, s_.amax(dim=-1))
            p = torch.exp(s_ - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_sum = l_sum * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + p.to(q.dtype).float() @ vb
            m = m_new
        out = acc / torch.clamp_min(l_sum, 1e-30)[..., None]
        blocks.append(out.to(q.dtype))
    out = torch.cat(blocks, dim=2).transpose(1, 2)
    return out[:, :sq]


def _scores(q: torch.Tensor, k_cache: torch.Tensor, visible: torch.Tensor,
            k_scale: torch.Tensor | None = None):
    """(float32 (KV, rep)-factored scores (B, KV, rep, C, S) with the
    invisible keys at ``NEG_INF``, rep)."""
    b, c, h, hd = q.shape
    kvh = k_cache.shape[2]
    rep = h // kvh
    qg = q.reshape(b, c, kvh, rep, hd).float() / math.sqrt(hd)
    s = torch.einsum("bqkrd,bskd->bkrqs", qg, k_cache.float())
    if k_scale is not None:
        s = s * k_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    return torch.where(visible[:, None, None], s,
                       torch.full_like(s, NEG_INF))


def _attend(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            visible: torch.Tensor, k_scale: torch.Tensor | None = None,
            v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Shared body: q (B, C, H, hd) over caches (B, S, KV, hd) with a
    (B, C, S) visibility mask; the cache is contracted un-repeated
    against (KV, rep)-factored q, softmax in float32.  With an int8
    cache, the (B, S, KV) scales fold in exactly: q.(k*s) = (q.k)*s into
    the scores, sum_s (p*s_v).v into the probabilities."""
    b, c, h, hd = q.shape
    p = torch.softmax(_scores(q, k_cache, visible, k_scale), dim=-1)
    if v_scale is not None:
        p = p * v_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bkrqs,bskd->bqkrd", p, v_cache.float())
    return out.reshape(b, c, h, hd).to(q.dtype)


def _attend_partial(q, k_cache, v_cache, visible, k_scale, v_scale,
                    reduce_max, reduce_sum) -> torch.Tensor:
    """``_attend`` over one rank's piece of a sequence split across
    ranks: its partial softmax (the max, the sum of exp and the weighted
    sum of V, in float32), combined by ``reduce_max`` then ``reduce_sum``
    (all-reduces over the sequence's mesh axes) before the division."""
    b, c, h, hd = q.shape
    s = _scores(q, k_cache, visible, k_scale)
    m = reduce_max(s.amax(dim=-1))
    p = torch.exp(s - m[..., None])
    denom = reduce_sum(p.sum(dim=-1))                    # (B, KV, rep, C)
    if v_scale is not None:
        p = p * v_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    acc = reduce_sum(torch.einsum("bkrqs,bskd->bqkrd", p, v_cache.float()))
    out = acc / denom.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, c, h, hd).to(q.dtype)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None, *,
                     seq=None) -> torch.Tensor:
    """Single-step decode attention: q (B, 1, H, hd) over caches
    (B, S_max, KV, hd) — bf16, or int8 with (B, S_max, KV) scales;
    entries at index >= cache_len ((B,) or scalar) are masked.  ``seq``
    = (s_lo, reduce_max, reduce_sum) for a cache that holds positions
    s_lo.. of a sequence split over ranks (``_attend_partial``)."""
    s_max = k_cache.shape[1]
    s_lo = 0 if seq is None else seq[0]
    pos = torch.arange(s_lo, s_lo + s_max, device=q.device)
    lens = torch.as_tensor(cache_len, device=q.device)
    lens = lens[:, None] if lens.dim() == 1 else lens.reshape(1, 1)
    visible = (pos[None, :] < lens)[:, None, :]          # (B|1, 1, S)
    visible = visible.expand(q.shape[0], 1, s_max)
    if seq is None:
        return _attend(q, k_cache, v_cache, visible, k_scale, v_scale)
    return _attend_partial(q, k_cache, v_cache, visible, k_scale, v_scale,
                           *seq[1:])


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
