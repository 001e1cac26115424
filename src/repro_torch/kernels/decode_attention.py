"""Decode attention: the launch wrapper of the hand-written Hopper kernel
(``csrc/decode_attention.cu``), its plain version, and
``decode_attention``, which dispatches between them.

The kernel replaces no ``pallas_call``: the reference computes a decode
token's attention in ``jnp`` (``src/repro/models/transformer.py``
``attn_decode_core``: RoPE, the masked ``where`` of the new K / V row
into the cache, then ``layers.attention_decode``'s float32 softmax).  One
launch a layer does all three for one token a sequence: q and k rotated
in the kernel (the plain version's formula and rounding), the new row
written at row ``pos`` of the caches it is given (its only write), and
each q head attending over rows 0..pos of its KV head, GQA read
un-repeated, in float32, the output in the cache's type.

Shapes: q (B, 1, H, hd); k, v (B, 1, KV, hd); the layer's caches
(B, S, KV, hd); ``pos`` (B,) int32, each sequence's new row
(``cache["len"]``) -> out (B, 1, H, hd).

``decode_attention_cuda`` takes CUDA tensors only, checks them and calls
``torch.ops.repro_torch.decode_attention`` (``kernels/library.py``),
whose CUDA implementation allocates the output, launches on the current
stream, raises if the launch was refused, and adds one to
``LAUNCHES["decode_attention"]``; on fake tensors its Meta implementation
gives the output's shape and dtype and launches nothing.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.library import define
from repro_torch.kernels.ops import _resolve, _use_kernel
from repro_torch.models import layers as L

__all__ = ["LAUNCHES", "reset_launches", "HEAD_DIMS", "REPS", "DTYPES",
           "takes", "decode_attention_ref", "decode_attention_cuda",
           "decode_attention"]

# kernel launches since the last reset
LAUNCHES = {"decode_attention": 0}

HEAD_DIMS = (64, 128)               # the head widths the kernel is built for
REPS = tuple(range(1, 9))           # q heads a KV head (H / KV) it is built for
DTYPES = (torch.bfloat16, torch.float16)
MAX_SPLITS = 8                      # blocks a cluster (kMaxSplits)
BLOCKS_AN_SM = 4                    # blocks an SM holds at once (registers)
KERNELS_A_CALL = 1                  # launches a call


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def decode_attention_ref(q, k, v, k_cache, v_cache, pos, theta: float,
                         rope: bool):
    """The plain version: RoPE (``layers.apply_rope``; none without
    ``rope``), the reference's masked ``where`` of the new row into new
    cache tensors (the caller's are never modified), then
    ``layers.attention_decode`` over rows 0..pos.  Returns (out, k_cache,
    v_cache)."""
    pos = pos.to(torch.int32)
    if rope:
        q, k = L.apply_rope(q, k, pos[:, None], theta)
    at_pos = (torch.arange(k_cache.shape[1], dtype=torch.int32,
                           device=pos.device)[None]
              == pos[:, None])[..., None, None]           # (B, S, 1, 1)
    k_cache = torch.where(at_pos, k.to(k_cache.dtype), k_cache)
    v_cache = torch.where(at_pos, v.to(v_cache.dtype), v_cache)
    return L.attention_decode(q, k_cache, v_cache, pos + 1), k_cache, v_cache


def on_card(*tensors) -> bool:
    """True where the call launches the kernel: CUDA tensors (or a dry
    run's fake ones), unless ``ESPIM_IMPL=ref`` pins the plain versions."""
    return _use_kernel(_resolve(None), *tensors)


def _fits(q, k, v, k_cache, v_cache, pos) -> bool:
    """The shapes, dtypes, device and layout the kernel is built for."""
    if q.dim() != 4 or k_cache.dim() != 4:
        return False
    b, one, h, hd = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    return (one == 1 and hd in HEAD_DIMS and s >= 1 and kvh >= 1
            and h % kvh == 0 and h // kvh in REPS
            and tuple(k.shape) == tuple(v.shape) == (b, 1, kvh, hd)
            and tuple(k_cache.shape) == tuple(v_cache.shape) == (b, s, kvh,
                                                                 hd)
            and tuple(pos.shape) == (b,)
            and q.dtype in DTYPES
            and all(t.dtype == q.dtype for t in (k, v, k_cache, v_cache))
            and all(t.device == q.device for t in (k, v, k_cache, v_cache,
                                                    pos))
            and k_cache.is_contiguous() and v_cache.is_contiguous()
            and not L._needs_grad(q, k, v))


def takes(q, k, v, k_cache, v_cache, pos) -> bool:
    """The kernel's rule, read off the inputs alone: CUDA tensors, a
    bf16 or fp16 cache (the caller has excluded scales, M-RoPE and a
    sequence split over ranks), q of one token, hd in ``HEAD_DIMS``, H a
    multiple of KV with H / KV in ``REPS``, contiguous caches, nothing to
    differentiate."""
    return (on_card(q, k, v, k_cache, v_cache)
            and _fits(q, k, v, k_cache, v_cache, pos))


def splits(b: int, kvh: int, sms: int) -> int:
    """Blocks (one cluster) that share a sequence's live rows for one KV
    head: the most, up to ``MAX_SPLITS``, that keep the grid's B x KV x
    splits blocks within what ``sms`` SMs hold at once
    (``BLOCKS_AN_SM`` each).  2 at B 32 x KV 8 on 132 SMs, 8 at B 1."""
    n = MAX_SPLITS
    while n > 1 and b * kvh * n > BLOCKS_AN_SM * sms:
        n //= 2
    return n


def _kernel(q, k, v, k_cache, v_cache, pos, theta: float, rope: bool):
    b, _, h, hd = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    rc = load_library("decode_attention").decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), pos.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.float16), b, s, kvh, h // kvh, hd,
        splits(b, kvh, sms), theta, int(rope),
        math.log2(math.e) / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:     # a cudaError_t
        raise RuntimeError(f"decode_attention launch failed: rc {rc}")
    LAUNCHES["decode_attention"] += KERNELS_A_CALL
    return out


_decode = define(
    "decode_attention(Tensor q, Tensor k, Tensor v, Tensor(a!) k_cache, "
    "Tensor(b!) v_cache, Tensor pos, float theta, bool rope) -> Tensor",
    _kernel,
    lambda q, k, v, k_cache, v_cache, pos, theta, rope: torch.empty_like(q),
    lambda q, k, v, k_cache, v_cache, pos, theta, rope: (
        4 * q.shape[0] * q.shape[2] * q.shape[3] * k_cache.shape[1]))


def _need_cuda(*tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if not (t.is_cuda and t.device == dev):
            raise ValueError(f"decode_attention_cuda needs CUDA tensors on "
                             f"{dev}, got one on {t.device}")


def decode_attention_cuda(q, k, v, k_cache, v_cache, pos, theta: float,
                          rope: bool = True) -> torch.Tensor:
    """One kernel launch: writes row ``pos[b]`` of ``k_cache`` /
    ``v_cache`` in place (where it is < S) and returns out (B, 1, H, hd).
    Raises for what the kernel does not take."""
    _need_cuda(q, k, v, k_cache, v_cache, pos)
    if not _fits(q, k, v, k_cache, v_cache, pos):
        raise ValueError(
            f"decode_attention_cuda takes q (B, 1, H, hd), k / v (B, 1, KV, "
            f"hd), contiguous caches (B, S, KV, hd) of q's dtype in {DTYPES}, "
            f"hd in {HEAD_DIMS}, H / KV in {REPS}, pos (B,), all on one "
            f"device, nothing that requires grad; got q "
            f"{q.dtype}{tuple(q.shape)}, k "
            f"{tuple(k.shape)}, cache {k_cache.dtype}{tuple(k_cache.shape)}, "
            f"pos {tuple(pos.shape)}")
    return _launch(q, k, v, k_cache, v_cache, pos, theta, rope)


def _launch(q, k, v, k_cache, v_cache, pos, theta, rope) -> torch.Tensor:
    """The launch on inputs the kernel takes."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    return _decode(q, k, v, k_cache, v_cache,
                   pos.to(torch.int32).contiguous(), float(theta), bool(rope))


def decode_attention(q, k, v, k_cache, v_cache, pos, theta: float, *,
                     rope: bool = True, donate: bool = False):
    """One decode token's RoPE, cache write and attention -> (out,
    k_cache, v_cache).  Where ``takes`` holds, one kernel launch, which
    writes the new rows into ``k_cache`` / ``v_cache`` themselves and
    returns them with ``donate``, else into a copy of each; a launch
    failure raises.  Otherwise (the CPU, the ``ESPIM_IMPL=ref`` pin,
    another head width or dtype) the plain version, which returns new
    caches and leaves the given ones as they were."""
    if takes(q, k, v, k_cache, v_cache, pos):
        if not donate:
            k_cache, v_cache = k_cache.clone(), v_cache.clone()
        out = _launch(q, k, v, k_cache, v_cache, pos, theta, rope)
        return out, k_cache, v_cache
    return decode_attention_ref(q, k, v, k_cache, v_cache, pos, theta, rope)
