"""Plain PyTorch versions of the ESPIM kernels.

Each function mirrors its namesake in the JAX package's
``repro/kernels/ref.py`` (``flash_attention_ref``: the math of
``repro/kernels/flash_attention.py``) op for op: the CPU tests hold them
against that module and against the Pallas kernels (interpret mode), and
``chip_smoke.py`` holds the hand-written CUDA kernels
(``kernels/espim_spmv.py``, ``kernels/dense_mv.py``,
``kernels/flash_attention.py``, ``kernels/wkv.py``) against them on the
card.  ``wkv6_ref`` is the scan of ``repro/models/rwkv.time_mix_apply``
(a ``lax.scan``, no Pallas kernel) one token at a time, and
``wkv6_bwd_ref`` its gradient as an explicit reverse-time loop.
``kernels/ops.py`` runs them for tensors that lie on the CPU.

Layouts: column-chunked ELL — values/cols ``(R_pad, K, Lc)`` with
chunk-local column ids into one ``chunk_cols``-wide slab of ``x (M, B)``;
pad slots carry value 0 and column 0, and ``x`` is zero-padded to
``K * chunk_cols``.  The plain ELL layout — values/cols ``(R_pad, L)``
with global column ids — has plain versions only.  Every function
accumulates in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "espim_spmv_ref",
    "espim_spmv_batched_ref",
    "espim_spmv_chunked_ref",
    "espim_spmv_batched_chunked_ref",
    "espim_spmv_batched_chunked_quant_ref",
    "nibble_unpack_ref",
    "scatter_rows_ref",
    "epilogue_act",
    "glu_epilogue_ref",
    "espim_spmv_batched_chunked_glu_ref",
    "espim_spmv_batched_chunked_quant_glu_ref",
    "espim_spmv_group_ref",
    "MULRED_MAX_BLOCK",
    "dense_mv_ref",
    "flash_attention_ref",
    "NEG_INF",
    "wkv6_ref",
    "wkv6_bwd_ref",
]


def _relu2(v: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(v))


def _gelu_tanh(v: torch.Tensor) -> torch.Tensor:
    return F.gelu(v, approximate="tanh")


_ACTS = {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu,
         "relu2": _relu2}


def epilogue_act(name: str):
    """Activation of the fused GLU epilogue; ``gelu`` is the tanh form,
    as in the reference (``jax.nn.gelu(approximate=True)``)."""
    try:
        return _ACTS[name]
    except KeyError:
        raise ValueError(f"unknown epilogue activation {name!r}") from None


def glu_epilogue_ref(acc: torch.Tensor, act: str) -> torch.Tensor:
    """act(gate) * up over a half-major (2*Rg, ...) packed accumulator —
    gate rows first, up rows second, both halves in one packed order."""
    rg = acc.shape[0] // 2
    return epilogue_act(act)(acc[:rg]) * acc[rg:]


def espim_spmv_ref(values: torch.Tensor, cols: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Plain ELL MV: values, cols (R_pad, L) with global ids; x (M,) ->
    (R_pad,) float32.  Pad slots carry value 0 and contribute nothing."""
    xv = x[cols.long()]                                 # (R_pad, L)
    return torch.sum(values.float() * xv.float(), dim=1)


def espim_spmv_batched_ref(values: torch.Tensor, cols: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """Plain batched ELL MV: x (M, B) -> (R_pad, B) float32."""
    xv = x[cols.long()]                                 # (R_pad, L, B)
    return torch.einsum("rl,rlb->rb", values.float(), xv.float())


def _pad_x_to_chunks(x: torch.Tensor, n_chunks: int, chunk_cols: int
                     ) -> torch.Tensor:
    """Zero-pad dim 0 of x (M,) or (M, B) to ``n_chunks * chunk_cols``."""
    pad = n_chunks * chunk_cols - x.shape[0]
    if pad:
        x = F.pad(x, (0, 0) * (x.dim() - 1) + (0, pad))
    return x


def espim_spmv_chunked_ref(values: torch.Tensor, cols: torch.Tensor,
                           x: torch.Tensor, chunk_cols: int) -> torch.Tensor:
    """Unbatched chunked-ELL MV: values (float32 or bfloat16), cols
    (R_pad, K, Lc) chunk-local; x (M,) -> (R_pad,) float32.  Rebases the
    ids to global columns and gathers once (the reference's oracle)."""
    k = values.shape[1]
    xp = _pad_x_to_chunks(x, k, chunk_cols)
    base = torch.arange(k, device=cols.device) * chunk_cols
    xv = xp[cols.long() + base[None, :, None]]          # (R_pad, K, Lc)
    return torch.sum(values.float() * xv.float(), dim=(1, 2))


def _gather_chunk(xp: torch.Tensor, cols_k: torch.Tensor, i: int,
                  chunk_cols: int) -> torch.Tensor:
    """Rows of chunk ``i``'s (chunk_cols, B) slab at the local ids
    ``cols_k`` (R, Lc) -> (R, Lc, B) float32."""
    xk = xp[i * chunk_cols:(i + 1) * chunk_cols]
    g = torch.index_select(xk, 0, cols_k.reshape(-1))
    return g.reshape(*cols_k.shape, xp.shape[1]).float()


def espim_spmv_batched_chunked_ref(values: torch.Tensor, cols: torch.Tensor,
                                   x: torch.Tensor, chunk_cols: int
                                   ) -> torch.Tensor:
    """Batched chunked-ELL MV: x (M, B) -> (R_pad, B) float32, one chunk's
    gather-accumulate at a time (the reference's schedule)."""
    r_pad, k, _lc = values.shape
    xp = _pad_x_to_chunks(x, k, chunk_cols)
    acc = torch.zeros((r_pad, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for i in range(k):
        g = _gather_chunk(xp, cols[:, i], i, chunk_cols)
        acc = acc + torch.einsum("rl,rlb->rb", values[:, i].float(), g)
    return acc


def nibble_unpack_ref(packed: torch.Tensor) -> torch.Tensor:
    """uint8 (..., P) -> int4 codes in an int8 container (..., 2P); slot 2j
    is the low nibble of byte j.  Sign extension is two arithmetic shifts
    on the int8 bit pattern."""
    b = packed.view(torch.int8)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(b, 4), 4)
    hi = torch.bitwise_right_shift(b, 4)
    inter = torch.stack([lo, hi], dim=-1)              # (..., P, 2)
    return inter.reshape(*packed.shape[:-1], 2 * packed.shape[-1])


# Lc * B at or under this -> fused multiply-reduce, else einsum: the same
# formulation switch as the reference's quantized lowering
MULRED_MAX_BLOCK = 256


def espim_spmv_batched_chunked_quant_ref(codes: torch.Tensor,
                                         cols: torch.Tensor,
                                         scales: torch.Tensor | None,
                                         x: torch.Tensor, chunk_cols: int,
                                         group_rows: int) -> torch.Tensor:
    """Quantized batched chunked-ELL MV: int8 codes, or nibble-packed uint8
    (inferred from the width mismatch vs ``cols``), x (M, B) -> (R_pad, B)
    float32.  The per-row-group scale multiplies the accumulated output
    once; ``scales=None`` returns the code-domain accumulator."""
    r_pad, k, _lc = codes.shape
    if codes.shape[-1] != cols.shape[-1]:              # nibble-packed plane
        codes = nibble_unpack_ref(codes)[..., :cols.shape[-1]]
    b = x.shape[1]
    mulred = cols.shape[-1] * b <= MULRED_MAX_BLOCK
    xp = _pad_x_to_chunks(x, k, chunk_cols)
    acc = torch.zeros((r_pad, b), dtype=torch.float32, device=x.device)
    for i in range(k):
        g = _gather_chunk(xp, cols[:, i], i, chunk_cols)
        ci = codes[:, i].float()
        if mulred:
            acc = acc + torch.sum(ci[:, :, None] * g, dim=1)
        else:
            acc = acc + torch.einsum("rl,rlb->rb", ci, g)
    if scales is None:                                 # caller owns scaling
        return acc
    srow = torch.repeat_interleave(scales.float(), group_rows)
    return acc * srow[:, None]


def espim_spmv_batched_chunked_glu_ref(values: torch.Tensor,
                                       cols: torch.Tensor, x: torch.Tensor,
                                       chunk_cols: int, act: str
                                       ) -> torch.Tensor:
    """Gated MV over the half-major (2*Rg, K, Lc) gate+up pack: the same
    accumulate as the unfused version, then act(gate) * up -> (Rg, B)."""
    acc = espim_spmv_batched_chunked_ref(values, cols, x, chunk_cols)
    return glu_epilogue_ref(acc, act)


def espim_spmv_batched_chunked_quant_glu_ref(codes: torch.Tensor,
                                             cols: torch.Tensor,
                                             srow: torch.Tensor,
                                             x: torch.Tensor, chunk_cols: int,
                                             act: str) -> torch.Tensor:
    """Quantized gated MV: code-domain accumulate, both halves times the
    per-row scales ``srow`` (2*Rg,), then act(gate) * up -> (Rg, B)."""
    acc = espim_spmv_batched_chunked_quant_ref(codes, cols, None, x,
                                               chunk_cols, 1)
    return glu_epilogue_ref(acc * srow.float()[:, None], act)


def espim_spmv_group_ref(values: list, cols: list, x: torch.Tensor,
                         chunk_cols: int, srow: list | None = None,
                         perm: torch.Tensor | None = None,
                         n_out: int | None = None, act: str | None = None
                         ) -> torch.Tensor:
    """One packed group's buckets -> (n_out, B) float32, in the decode
    step's ops (the reference's ``_group_apply`` then ``_group_take``):
    each bucket's batched version — the code-domain accumulator times its
    per-row ``srow`` for a quantized plane; the fused GLU version with
    ``act`` — then the buckets' outputs concatenated in order and, for a
    take group, packed row p copied to output row ``perm[p]`` (pad rows,
    -1, dropped)."""
    quant = values[0].dtype in (torch.int8, torch.uint8)
    parts = []
    for i, (v, c) in enumerate(zip(values, cols)):
        s = None if srow is None else srow[i]
        if act is not None and quant:
            parts.append(espim_spmv_batched_chunked_quant_glu_ref(
                v, c, s, x, chunk_cols, act))
        elif act is not None:
            parts.append(espim_spmv_batched_chunked_glu_ref(v, c, x,
                                                            chunk_cols, act))
        elif quant:
            yp = espim_spmv_batched_chunked_quant_ref(v, c, None, x,
                                                      chunk_cols, 1)
            parts.append(yp if s is None else yp * s[:, None])
        else:
            parts.append(espim_spmv_batched_chunked_ref(v, c, x, chunk_cols))
    yp = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
    if perm is None:
        return yp
    # pad rows go to one spare row past the output, dropped after the copy
    # (no data-dependent shape: a CUDA graph can capture it)
    n = yp.shape[0] if n_out is None else n_out
    dst = torch.where(perm >= 0, perm, n).long()
    out = yp.new_zeros((n + 1, yp.shape[1]))
    out[dst] = yp
    return out[:n]


def dense_mv_ref(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Dense MV (Newton's datapath analogue): w (R, C) @ x (C,) -> (R,)
    float32."""
    return torch.matmul(w.float(), x.float())


NEG_INF = -1e30     # the reference kernel's mask value


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: float | None = None
                        ) -> torch.Tensor:
    """Attention over (BH, S, hd) by a plain masked softmax in float32:
    scores of q·scale (default 1/sqrt(hd)) against k, keys after the
    query masked when ``causal`` (q_pos >= k_pos kept), softmax, times v;
    the output is cast to q's dtype, as the kernel's is."""
    s, hd = q.shape[1], q.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    scores = (q.float() * scale) @ k.float().transpose(1, 2)
    if causal:
        pos = torch.arange(s, device=q.device)
        scores = scores.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return (p @ v.float()).to(q.dtype)


def scatter_rows_ref(y_packed: torch.Tensor, perm: torch.Tensor,
                     n_rows: int) -> torch.Tensor:
    """Map packed-row outputs back to original row ids (perm < 0 = pad)."""
    keep = perm >= 0
    safe = torch.where(keep, perm, torch.zeros_like(perm)).long()
    contrib = torch.where(
        keep.reshape(keep.shape + (1,) * (y_packed.ndim - 1)), y_packed,
        torch.zeros_like(y_packed))
    out = torch.zeros((n_rows,) + tuple(y_packed.shape[1:]),
                      dtype=y_packed.dtype, device=y_packed.device)
    return out.index_add_(0, safe, contrib)


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """The WKV recurrence in float32, one token at a time in order: r / k
    / w (B, S, H, K), v (B, S, H, V), u (H, K), state (B, H, K, V) ->
    (y (B, S, H, V), the new state).  ``y`` sums over K, so a K slice of
    every head gives a partial ``y``."""
    u = u.float()[None, :, :, None]
    st = state.float()
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t].float(), v[:, t].float())
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t].float(),
                               st + u * kv))
        st = w[:, t].float()[..., None] * st + kv
    return torch.stack(ys, dim=1), st


def wkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                 gy: torch.Tensor, g_state: torch.Tensor):
    """The gradient of ``wkv6_ref`` by a reverse-time loop: the saved
    inputs (``state`` the initial one), ``gy`` (B, S, H, V) and
    ``g_state`` (B, H, K, V) -> (dr, dk, dv, dw, du, d_state0),
    float32.  With S_t the state after step t, dS_t its
    gradient and kv = k_t v_t^T:

      dr_t[k] = sum_j gy_t[j] (S_{t-1}[k,j] + u[k] k_t[k] v_t[j])
      d(kv) = u r_t gy_t^T + dS_t;  dk_t = d(kv) v_t;  dv_t = d(kv)^T k_t
      du += r_t * k_t * (gy_t . v_t);  dw_t[k] = sum_j dS_t[k,j] S_{t-1}[k,j]
      dS_{t-1} = r_t gy_t^T + w_t * dS_t

    The forward's states are recomputed and kept, one per step."""
    rf, kf, vf, wf, gf = (t.float() for t in (r, k, v, w, gy))
    uf = u.float()
    st = state.float()
    prev = []
    for t in range(r.shape[1]):
        prev.append(st)
        st = (wf[:, t][..., None] * st
              + torch.einsum("bhk,bhv->bhkv", kf[:, t], vf[:, t]))
    ds = g_state.float()
    dr, dk, dw = (torch.empty_like(rf) for _ in range(3))
    dv = torch.empty_like(vf)
    du = torch.zeros_like(uf)
    for t in reversed(range(r.shape[1])):
        r_t, k_t, v_t, w_t, g_t = rf[:, t], kf[:, t], vf[:, t], wf[:, t], \
            gf[:, t]
        s_prev = prev[t]
        gv = (g_t * v_t).sum(-1, keepdim=True)              # (B, H, 1)
        dr[:, t] = (torch.einsum("bhv,bhkv->bhk", g_t, s_prev)
                    + uf * k_t * gv)
        dkv = (uf * r_t)[..., None] * g_t[:, :, None, :] + ds
        dk[:, t] = torch.einsum("bhkv,bhv->bhk", dkv, v_t)
        dv[:, t] = torch.einsum("bhkv,bhk->bhv", dkv, k_t)
        du += (r_t * k_t * gv).sum(0)
        dw[:, t] = (ds * s_prev).sum(-1)
        ds = r_t[..., None] * g_t[:, :, None, :] + w_t[..., None] * ds
    return dr, dk, dv, dw, du, ds
