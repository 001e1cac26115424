"""The WKV recurrence of RWKV6 as one op: the launch wrappers of the
hand-written Hopper kernels (``csrc/wkv.cu``, forward and backward),
their ``torch.library`` ops, and ``wkv6``, the autograd-aware entry
point.

The kernels replace no Pallas kernel: the reference writes the recurrence
as one ``jax.lax.scan`` (``src/repro/models/rwkv.py:103-116``), which XLA
compiles into a single loop; eager PyTorch ran it as a Python loop of
five small ops a token (``kernels/ref.wkv6_ref``, which stays as the
plain version).

Shapes: r / k / w (B, S, H, K'), v (B, S, H, V), u (H, K'), state (B,
H, K', V) float32, K' and V at most 64 (K' is the head width, or one
rank's K slice at sharded decode) -> y (B, S, H, V) and the final state,
float32.  bf16 r / k / v are read as they are and widened in the kernel
(exactly); any other dtype is cast to float32 first, as the plain
version's ``.float()`` does.

``wkv6_cuda`` / ``wkv6_bwd_cuda`` take CUDA tensors only, check them and
call ``torch.ops.repro_torch.wkv6`` / ``wkv6_bwd`` (``kernels/
library.py``), whose CUDA implementations allocate the outputs, launch
on the current stream, raise if the launch was refused, and add one to
``LAUNCHES``; on fake tensors their Meta implementations give the
outputs' shapes and dtypes and launch nothing.  With ``chunk`` =
``CHUNK`` the forward also writes the state before every ``CHUNK``-th
step (``ckpt`` (B, H, ceil(S / CHUNK), K', V)), from which the backward
recomputes each chunk's states: ``CHUNK`` x fewer saved bytes than a
state a step (67 MB instead of 2.15 GB a layer a device at rwkv6-1.6b's
``train_4k`` on 16 x 16).

``wkv6`` is the one entry point and decides where a call runs, as
``models/layers.flash_attention`` does: CUDA tensors, and a
dry run's fake or meta tensors of any device, take the kernels (under
autograd through ``_WKV6``, a ``torch.autograd.Function`` whose forward
is the forward kernel, saving the checkpoints, and whose backward is the
backward kernel; a failed build or launch raises); CPU tensors, and the
``ESPIM_IMPL=ref`` pin, take ``wkv6_ref`` (autograd differentiates its
loop).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.build import load_library
from repro_torch.kernels.library import define
from repro_torch.kernels.ops import _resolve, _use_kernel

__all__ = ["LAUNCHES", "reset_launches", "CHUNK", "on_device", "Plan",
           "wkv6_cuda", "wkv6_bwd_cuda", "wkv6"]

# kernel launches since the last reset
LAUNCHES = {"wkv6": 0, "wkv6_bwd": 0}

CHUNK = 32          # steps between checkpoints (WKV_CHUNK in csrc/wkv.cu)
MAX_WIDTH = 64      # K' and V the kernels take (WKV_MAXK / WKV_MAXV)
TILE = 16           # steps a forward tile (WKV_TILE); chunk a multiple
ROWS = 4            # state rows a forward thread owns (WKV_ROWS)
MAX_THREADS = 256   # most threads a forward CTA (WKV_FWD_THREADS)
FILL_CTAS = 128     # a grid this large fills the H100's 132 SMs once


class Plan(NamedTuple):
    """The forward's launch: ``kg`` k-groups of ``ROWS`` rows (from K'
    alone, so the order of ``y``'s sums, and its bits, do not depend on
    B) and ``vs`` columns a CTA: ceil(V / vs) CTAs a (b, h) of kg * vs
    compute threads (the kernel adds one copier warp); thread t of a CTA
    keeps rows ROWS (t % kg) .. of column t / kg of the CTA's vs."""
    kg: int
    vs: int


def _plan(b: int, h: int, kp: int, vd: int) -> Plan:
    """The forward's launch at B ``b`` x H ``h``, K' ``kp`` x V ``vd``:
    the fewest k-groups (a power of 2) whose ``ROWS`` rows cover K'; then
    as many columns a CTA as the head has (a power of 2, at most
    ``MAX_THREADS`` threads and at least a warp), halved while the grid
    is below ``FILL_CTAS`` and a CTA stays a warp or more.  At rwkv6's
    B 1 x H 32 x 64 x 64: 16 k-groups x 16 columns, 128 CTAs of 256
    threads."""
    if not (1 <= kp <= MAX_WIDTH and 1 <= vd <= MAX_WIDTH):
        raise ValueError(f"K' {kp} and V {vd} must be in 1..{MAX_WIDTH}")
    kg = 1
    while ROWS * kg < kp:
        kg *= 2
    vs = 2
    while vs < vd:
        vs *= 2
    vs = max(min(vs, MAX_THREADS // kg), 32 // kg, 2)
    while (b * h * -(-vd // vs) < FILL_CTAS and vs // 2 >= 2
           and kg * (vs // 2) >= 32):
        vs //= 2
    return Plan(kg, vs)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _real(t: torch.Tensor) -> bool:
    """A tensor with storage (not fake, not meta)."""
    return not (t.is_meta or isinstance(t, FakeTensor))


def on_device(*tensors) -> bool:
    """True where the op runs its CUDA or Meta implementation: a CUDA
    tensor, or a fake or meta tensor of any device (a dry run's trace);
    False for real CPU tensors, which take the plain version."""
    return any(t.is_cuda or not _real(t) for t in tensors)


def _fwd_flops(r, k, v, w, u, state, chunk) -> int:
    """The forward's products as ``CostMode`` counts the plain loop's:
    the ``y`` contraction, one ``bmm`` of 2 K' V a (b, t, h) (the
    outer product k v^T dispatches as a broadcast multiply)."""
    b, s, h, kp = r.shape
    return 2 * b * s * h * kp * v.shape[-1]


def _bwd_flops(r, k, v, w, u, ckpt, gy, g_state, chunk) -> int:
    """The backward's products as ``CostMode`` counts autograd of the
    plain loop: the ``y`` contraction's two ``bmm`` gradients."""
    b, s, h, kp = r.shape
    return 4 * b * s * h * kp * v.shape[-1]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _fwd_kernel(r, k, v, w, u, state, chunk: int):
    b, s, h, kp = r.shape
    vd = v.shape[-1]
    f32 = torch.float32
    y = torch.empty((b, s, h, vd), dtype=f32, device=r.device)
    n_ck = -(-s // chunk) if chunk else 0
    st = torch.empty((b, h, kp, vd), dtype=f32, device=r.device)
    ckpt = torch.empty((b, h, n_ck, kp, vd), dtype=f32, device=r.device)
    plan = _plan(b, h, kp, vd)
    rc = load_library("wkv").wkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), state.data_ptr(), y.data_ptr(), st.data_ptr(),
        ckpt.data_ptr(), int(r.dtype == torch.bfloat16), b, s, h, kp, vd,
        chunk, plan.kg, plan.vs, _stream(r))
    if rc != 0:     # a cudaError_t
        raise RuntimeError(f"wkv6 forward launch failed: rc {rc}")
    LAUNCHES["wkv6"] += 1
    return y, st, ckpt


def _fwd_meta(r, k, v, w, u, state, chunk: int):
    b, s, h, kp = r.shape
    vd = v.shape[-1]
    n_ck = -(-s // chunk) if chunk else 0
    f32 = torch.float32
    return (r.new_empty((b, s, h, vd), dtype=f32),
            r.new_empty((b, h, kp, vd), dtype=f32),
            r.new_empty((b, h, n_ck, kp, vd), dtype=f32))


def _bwd_buffers(r, v) -> dict:
    """The backward launch's outputs and its one scratch, ``du_part`` (B,
    H, K') for the sum over the batch: the chunks' states stay in the
    kernel's shared memory, so nothing grows with S but the outputs."""
    b, s, h, kp = r.shape
    vd = v.shape[-1]
    f32 = dict(dtype=torch.float32, device=r.device)
    return {"dr": torch.empty((b, s, h, kp), **f32),
            "dk": torch.empty((b, s, h, kp), **f32),
            "dv": torch.empty((b, s, h, vd), **f32),
            "dw": torch.empty((b, s, h, kp), **f32),
            "du": torch.empty((h, kp), **f32),
            "ds0": torch.empty((b, h, kp, vd), **f32),
            "du_part": torch.empty((b, h, kp), **f32)}


def _bwd_kernel(r, k, v, w, u, ckpt, gy, g_state, chunk: int):
    b, s, h, kp = r.shape
    vd = v.shape[-1]
    o = _bwd_buffers(r, v)
    rc = load_library("wkv").wkv6_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), ckpt.data_ptr(), gy.data_ptr(), g_state.data_ptr(),
        *(o[n].data_ptr() for n in ("dr", "dk", "dv", "dw", "du", "ds0",
                                    "du_part")),
        int(r.dtype == torch.bfloat16), b, s, h, kp, vd, chunk, _stream(r))
    if rc != 0:
        raise RuntimeError(f"wkv6 backward launch failed: rc {rc}")
    LAUNCHES["wkv6_bwd"] += 1
    return tuple(o[n] for n in ("dr", "dk", "dv", "dw", "du", "ds0"))


def _bwd_meta(r, k, v, w, u, ckpt, gy, g_state, chunk: int):
    f32 = torch.float32
    dr, dk, dw = (r.new_empty(r.shape, dtype=f32) for _ in range(3))
    return (dr, dk, v.new_empty(v.shape, dtype=f32), dw,
            u.new_empty(u.shape, dtype=f32),
            g_state.new_empty(g_state.shape, dtype=f32))


_fwd = define(
    "wkv6(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor state, "
    "int chunk) -> (Tensor, Tensor, Tensor)", _fwd_kernel, _fwd_meta,
    _fwd_flops)
_bwd = define(
    "wkv6_bwd(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
    "Tensor ckpt, Tensor gy, Tensor g_state, int chunk) -> (Tensor, Tensor, "
    "Tensor, Tensor, Tensor, Tensor)", _bwd_kernel, _bwd_meta, _bwd_flops)


def _operands(r, k, v, w, u, state) -> tuple:
    """The kernels' operands: r / k / v in one dtype, bfloat16 (4-byte
    aligned rows of even width: the tiles are copied in 4-byte words) or
    else float32; w, u and state float32; all contiguous."""
    f32, bf = torch.float32, torch.bfloat16
    rkv = (r, k, v)
    keep_bf = (all(t.dtype == bf for t in rkv)
               and r.shape[-1] % 2 == 0 and v.shape[-1] % 2 == 0)
    rkv = tuple(t.contiguous() if keep_bf else t.to(f32).contiguous()
                for t in rkv)
    if keep_bf and any(_real(t) and t.data_ptr() % 4 for t in rkv):
        rkv = tuple(t.clone() for t in rkv)
    return rkv + tuple(t.to(f32).contiguous() for t in (w, u, state))


def _check(r, k, v, w, u, state) -> None:
    if r.dim() != 4 or v.dim() != 4:
        raise ValueError(f"need r (B, S, H, K) and v (B, S, H, V), got "
                         f"{tuple(r.shape)} and {tuple(v.shape)}")
    b, s, h, kp = r.shape
    vd = v.shape[-1]
    want = {"k": (b, s, h, kp), "w": (b, s, h, kp), "v": (b, s, h, vd),
            "u": (h, kp), "state": (b, h, kp, vd)}
    for name, t in (("k", k), ("w", w), ("v", v), ("u", u),
                    ("state", state)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{want[name]} for r {tuple(r.shape)}")
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
    if not (1 <= s and 1 <= kp <= MAX_WIDTH and 1 <= vd <= MAX_WIDTH):
        raise ValueError(f"S {s} must be positive, K' {kp} and V {vd} in "
                         f"1..{MAX_WIDTH}: the kernels' plans cover at most "
                         f"{MAX_WIDTH} rows and columns a head")
    if r.numel() >= 2 ** 31 or v.numel() >= 2 ** 31:
        raise ValueError("r / v too large for the kernels' launch")


def _need_device(*tensors) -> None:
    for t in tensors:
        if not (t.is_cuda or not _real(t)):
            raise ValueError(f"the WKV kernels take CUDA tensors, got "
                             f"{t.device}")


def wkv6_cuda(r, k, v, w, u, state, chunk: int = 0):
    """One forward launch -> (y, the final state, the checkpoints: the
    state before every ``chunk``-th step, (B, H, 0, K', V) for ``chunk``
    0)."""
    _check(r, k, v, w, u, state)
    if chunk < 0 or chunk % TILE:
        raise ValueError(f"chunk {chunk} must be 0 or a positive multiple "
                         f"of {TILE}: checkpoints fall at a tile's start")
    _need_device(r, k, v, w, u, state)
    return _fwd(*_operands(r, k, v, w, u, state), int(chunk))


def wkv6_bwd_cuda(r, k, v, w, u, ckpt, gy, g_state):
    """One backward launch (and the deterministic pass summing ``du`` over
    the batch) from the forward's checkpoints taken with ``chunk`` =
    ``CHUNK`` -> (dr, dk, dv, dw, du, d_state0), float32."""
    _check(r, k, v, w, u, g_state)
    _need_device(r, k, v, w, u, ckpt, gy, g_state)
    b, s, h, kp = r.shape
    want = {"ckpt": ((b, h, -(-s // CHUNK), kp, v.shape[-1]), ckpt),
            "gy": ((b, s, h, v.shape[-1]), gy)}
    for name, (shape, t) in want.items():
        if tuple(t.shape) != shape or t.device != r.device:
            raise ValueError(f"{name} is {tuple(t.shape)} on {t.device}, "
                             f"want {shape} on {r.device} (checkpoints "
                             f"every {CHUNK} steps)")
    ops = _operands(r, k, v, w, u, g_state)
    return _bwd(*ops[:5], ckpt.float().contiguous(),
                gy.float().contiguous(), ops[5], CHUNK)


class _WKV6(torch.autograd.Function):
    """``wkv6`` under autograd on CUDA or fake tensors: the forward kernel
    (saving its checkpoints) and the backward kernel.  Gradients come
    back in each input's dtype, as autograd of the plain loop's casts
    gives them."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        y, st, ckpt = wkv6_cuda(r, k, v, w, u, state, CHUNK)
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        ctx.dtypes = tuple(t.dtype for t in (r, k, v, w, u, state))
        return y, st

    @staticmethod
    def backward(ctx, gy, g_state):
        grads = wkv6_bwd_cuda(*ctx.saved_tensors, gy, g_state)
        return tuple(g.to(dt) if need else None for g, dt, need in
                     zip(grads, ctx.dtypes, ctx.needs_input_grad))


def wkv6(r, k, v, w, u, state):
    """The WKV recurrence -> (y (B, S, H, V), the final state), float32:
    the kernels on CUDA or fake tensors (``_WKV6`` when autograd would
    record the call, else the forward op), ``wkv6_ref`` on CPU tensors or
    under the ``ESPIM_IMPL=ref`` pin; ``ESPIM_IMPL=cuda`` on CPU tensors
    raises."""
    ts = (r, k, v, w, u, state)
    impl = _resolve(None)
    if impl == "ref" or not (on_device(*ts) or _use_kernel(impl, *ts)):
        return _ref.wkv6_ref(*ts)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return _WKV6.apply(*ts)
    return wkv6_cuda(*ts)[:2]
