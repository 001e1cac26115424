"""The dense decoder, mirroring ``src/repro/models/transformer.py``, and
the attention building blocks the MoE / VLM / hybrid / enc-dec families
reuse: parameter init (``init_attn_layer``, ``init_mlp_layer``,
``init_norm``), the KV cache (compute dtype or int8 with per-token,
per-head scales), embedding and logits, the QKV projection, RMSNorm or
LayerNorm, RoPE / M-RoPE / learned positions, full-sequence attention
(``attn_apply``: self or cross, through ``layers.flash_attention``), the
projection-free attention cores (RoPE + cache write + attention) the
packed QKV / O groups wrap, the dense ``forward``, ``decode_step`` and
``prefill_chunk``, and what every family's full-sequence forward shares
for training: ``remat_wrap`` around the layer body and ``layer_list``.
On a mesh the dense family (the VLM flavour too, and the MoE family with
its own feed-forward block) also runs on each rank's shards:
``forward_sharded`` (ZeRO-3 on ``data``, tensor parallelism on
``model``) and ``decode_step_sharded`` (tensor-parallel products over
(``data``, ``model``) on the serving layout, over a cache split by batch
and by KV heads or sequence).

Params are the reference's dict layout: layer leaves stacked along a
leading layer axis, projections stored (d_in, d_out).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.sharding import partition as P
from repro_torch.telemetry.trace import get_tracer
from repro_torch.tree import flatten, tree_map

__all__ = ["init_params", "forward", "init_cache", "decode_step",
           "prefill_chunk", "init_attn_layer", "init_mlp_layer", "init_norm",
           "init_embed", "normal", "embed_tokens", "logits_from_hidden", "attn_apply",
           "attn_decode_core", "attn_decode_apply", "attn_prefill_core",
           "attn_prefill_apply", "splice_rows", "mlp_apply", "layer_slice",
           "layer_list", "remat_wrap", "tp_widths",
           "forward_sharded", "decode_step_sharded", "gather_rows",
           "decode_embed", "decode_attn", "decode_logits", "keep_row",
           "stacked_rows", "proj_tp", "heads_tp", "out_tp", "fsdp_tree"]


def normal(gen, shape, scale, dtype, device):
    """N(0, scale^2) draws from ``gen`` in float32, cast to ``dtype``."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def _generator(generator, dev):
    """The caller's generator, else one seeded 0 on ``dev`` (on the CPU
    for the meta device, which has none and draws nothing)."""
    if generator is None:
        gdev = "cpu" if dev.type == "meta" else dev
        generator = torch.Generator(device=gdev).manual_seed(0)
    return generator


def init_norm(cfg: ModelConfig, lead: tuple, device) -> dict:
    """Norm params with leading dims ``lead``: weight ones, and for a
    LayerNorm a zero bias."""
    p = {"w": torch.ones(lead + (cfg.d_model,), dtype=cfg.dtype,
                         device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros(lead + (cfg.d_model,), dtype=cfg.dtype,
                             device=device)
    return p


def init_attn_layer(cfg: ModelConfig, gen, lead: tuple, device) -> dict:
    """Attention projections N(0, 1/d_in) with leading dims ``lead`` (the
    layer axis, or none for zamba2's shared block); QKV biases zeros."""
    d, hd, dt = cfg.d_model, cfg.hd, cfg.dtype
    hq, hkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    p = {"wq": normal(gen, lead + (d, hq), d ** -0.5, dt, device),
         "wk": normal(gen, lead + (d, hkv), d ** -0.5, dt, device),
         "wv": normal(gen, lead + (d, hkv), d ** -0.5, dt, device),
         "wo": normal(gen, lead + (hq, d), hq ** -0.5, dt, device)}
    if cfg.qkv_bias:
        for name, width in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros(lead + (width,), dtype=dt, device=device)
    return p


def init_mlp_layer(cfg: ModelConfig, gen, lead: tuple, device) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    names = ("w_gate", "w_up") if cfg.gated_mlp else ("w_up",)
    p = {n: normal(gen, lead + (d, f), d ** -0.5, dt, device) for n in names}
    p["w_down"] = normal(gen, lead + (f, d), f ** -0.5, dt, device)
    return p


def init_embed(cfg: ModelConfig, gen, device) -> dict:
    """The embedding N(0, 0.02^2), the final norm and, untied, the lm_head
    N(0, 1/d)."""
    d = cfg.d_model
    out = {"embed": normal(gen, (cfg.padded_vocab, d), 0.02, cfg.dtype,
                           device),
           "final_norm": init_norm(cfg, (), device)}
    if not cfg.tie_embeddings:
        out["lm_head"] = normal(gen, (d, cfg.padded_vocab), d ** -0.5,
                                cfg.dtype, device)
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> dict:
    """Random params with the reference's init distribution: every
    projection N(0, 1/d_in), the embedding N(0, 0.02^2), norms ones
    (LayerNorm biases zeros), QKV biases zeros.  Draws come from
    ``generator`` (which must live on ``device``), so the numbers are
    torch's, not jax.random's — tests that compare the two packages
    convert the reference's params instead (``repro_torch.convert``)."""
    dev = resolve_device(device)
    gen = _generator(generator, dev)
    n = (cfg.n_layers,)
    # the layers draw first, then the embedding and lm_head: the order of
    # the dense family's draws since the first slice, so a seed gives the
    # same weights (and packs) as before
    layers = {"ln1": init_norm(cfg, n, dev),
              "attn": init_attn_layer(cfg, gen, n, dev),
              "ln2": init_norm(cfg, n, dev),
              "mlp": init_mlp_layer(cfg, gen, n, dev)}
    return {"layers": layers, **init_embed(cfg, gen, dev)}


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device=None) -> dict:
    """Zero KV cache (L, B, max_len, KV, hd) in the compute dtype, or int8
    with (L, B, max_len, KV) bf16 ``k_scale`` / ``v_scale`` when
    ``cfg.kv_cache_dtype == "int8"`` (``device="meta"`` gives the shapes
    without allocating)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.hd)
    lens = torch.zeros((batch_size,), dtype=torch.int32, device=dev)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=dev),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=dev),
                "len": lens}
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=dev),
            "len": lens}


def embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    return params["embed"][tokens.long()].to(cfg.cdtype)


def _norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return L.layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return L.rms_norm(x, p["w"], cfg.norm_eps)


def logits_from_hidden(cfg: ModelConfig, params: dict, h: torch.Tensor,
                       mesh=None):
    """Final norm, then the (tied or untied) vocab projection.  With a
    ``mesh`` (a tensor-parallel step) the embedding / lm_head is this
    rank's vocab shard on ``model``, and so are the logits."""
    h = _norm(cfg, params["final_norm"], h)
    if mesh is not None:
        h = P.copy_to(h, mesh)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", h, params["embed"].to(h.dtype))
    return L.dense(h, params["lm_head"])


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor):
    b, s, _ = x.shape
    q = L.dense(x, p["wq"], p.get("bq")).reshape(b, s, cfg.n_heads, cfg.hd)
    k = L.dense(x, p["wk"], p.get("bk")).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = L.dense(x, p["wv"], p.get("bv")).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    return q, k, v


def _rope(cfg: ModelConfig, q, k, positions, positions3=None):
    """M-RoPE when the config has it and (3, B, S) ``positions3`` are
    given, none for learned-position models, else standard RoPE."""
    if cfg.mrope and positions3 is not None:
        return L.apply_mrope(q, k, positions3, cfg.rope_theta)
    if cfg.learned_pos:
        return q, k
    return L.apply_rope(q, k, positions, cfg.rope_theta)


def attn_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, positions, *,
               causal: bool = True, positions3=None, kv_x=None):
    """Full attention over a sequence (train / prefill / cross): x (B, S,
    D) -> (B, S, D).  ``kv_x`` (B, T, D) switches to cross-attention
    (keys and values from the encoder); RoPE is skipped for it and for
    learned-position models."""
    b, s, _ = x.shape
    if kv_x is None:
        q, k, v = _qkv(cfg, p, x)
        q, k = _rope(cfg, q, k, positions, positions3)
    else:
        t = kv_x.shape[1]
        q = L.dense(x, p["wq"], p.get("bq")).reshape(b, s, cfg.n_heads,
                                                     cfg.hd)
        k = L.dense(kv_x, p["wk"], p.get("bk")).reshape(b, t, cfg.n_kv_heads,
                                                        cfg.hd)
        v = L.dense(kv_x, p["wv"], p.get("bv")).reshape(b, t, cfg.n_kv_heads,
                                                        cfg.hd)
    out = L.flash_attention(q, k, v, causal=causal, q_chunk=cfg.q_chunk,
                            kv_chunk=cfg.kv_chunk)
    return L.dense(out.reshape(b, s, cfg.n_heads * cfg.hd), p["wo"])


def _quantize_kv(x: torch.Tensor):
    """(B, T, KV, hd) -> (int8 codes, (B, T, KV) bf16 scales): one scale
    per token and head, max|x| / 127, round half to even."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def attn_decode_core(cfg: ModelConfig, q, k, v, k_cache, v_cache,
                     cache_len, k_scale=None, v_scale=None, *,
                     positions3=None, seq=None):
    """RoPE + cache write + attention for one decode token on precomputed
    heads.  q (B, 1, H, hd); k/v (B, 1, KV, hd); caches (B, S_max, KV, hd),
    int8 with (B, S_max, KV) ``k_scale`` / ``v_scale`` for an int8 cache;
    ``positions3`` (3, B, 1) for M-RoPE.  Returns (out (B, 1, H, hd) — pre-O-projection, k_cache, v_cache,
    k_scale, v_scale).

    The write is the reference's masked ``where`` into new cache tensors:
    the caller's cache is never modified, so two paths can decode from
    one cache.  ``seq`` = (s_lo, reduce_max, reduce_sum) when the caches
    hold positions s_lo.. of a sequence split over ranks: the new token
    lands only on the rank that holds its position, and the attention
    combines the ranks' partial softmax (``layers.attention_decode``)."""
    pos = cache_len.to(torch.int32)
    q, k = _rope(cfg, q, k, pos[:, None], positions3)
    s_max = k_cache.shape[1]
    s_lo = 0 if seq is None else seq[0]
    at_pos = (torch.arange(s_lo, s_lo + s_max, dtype=torch.int32,
                           device=pos.device)[None]
              == pos[:, None])[..., None, None]           # (B, S, 1, 1)
    if k_scale is not None:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        k_cache = torch.where(at_pos, kq, k_cache)
        v_cache = torch.where(at_pos, vq, v_cache)
        k_scale = torch.where(at_pos[..., 0], ks, k_scale)
        v_scale = torch.where(at_pos[..., 0], vs, v_scale)
    else:
        k_cache = torch.where(at_pos, k.to(k_cache.dtype), k_cache)
        v_cache = torch.where(at_pos, v.to(v_cache.dtype), v_cache)
    out = L.attention_decode(q, k_cache, v_cache, pos + 1,
                             k_scale=k_scale, v_scale=v_scale, seq=seq)
    return out, k_cache, v_cache, k_scale, v_scale


def attn_decode_apply(cfg: ModelConfig, p, x, k_cache, v_cache, cache_len,
                      k_scale=None, v_scale=None, *, positions3=None):
    """One-token decode through the dense attention weights ``p``.
    Returns (out (B, 1, D), k_cache, v_cache, k_scale, v_scale)."""
    tr = get_tracer()
    b = x.shape[0]
    with tr.span("attn.qkv", cat="forward"):
        q, k, v = _qkv(cfg, p, x)
    with tr.span("attn.core", cat="forward"):
        out, k_cache, v_cache, k_scale, v_scale = attn_decode_core(
            cfg, q, k, v, k_cache, v_cache, cache_len, k_scale, v_scale,
            positions3=positions3)
    with tr.span("attn.out", cat="forward"):
        out = L.dense(out.reshape(b, 1, cfg.n_heads * cfg.hd), p["wo"])
    return out, k_cache, v_cache, k_scale, v_scale


def splice_rows(cache: torch.Tensor, rows: torch.Tensor,
                start: torch.Tensor) -> torch.Tensor:
    """``rows`` (B, C, ...) written into a copy of ``cache`` (B, S, ...) at
    sequence rows start..start+C-1 (per-batch ``start`` (B,)); rows past
    S are dropped.  Masked gather + where, as the reference."""
    s_max, c = cache.shape[1], rows.shape[1]
    pos = torch.arange(s_max, dtype=torch.int32, device=cache.device)[None]
    st = start.to(torch.int32)[:, None]
    in_chunk = (pos >= st) & (pos < st + c)
    idx = torch.clamp(pos - st, 0, c - 1).long()
    extra = (1,) * (cache.ndim - 2)
    gathered = torch.take_along_dim(
        rows, idx.reshape(idx.shape + extra).expand(
            idx.shape + rows.shape[2:]), dim=1)
    return torch.where(in_chunk.reshape(in_chunk.shape + extra),
                       gathered.to(cache.dtype), cache)


def attn_prefill_core(cfg: ModelConfig, q, k, v, k_cache, v_cache, start,
                      k_scale=None, v_scale=None, *, positions3=None):
    """RoPE + cache splice + attention for a prefill chunk on precomputed
    heads.  q (B, C, H, hd); k/v (B, C, KV, hd); start (B,); ``positions3``
    (3, B, C) for M-RoPE.  Returns
    (out (B, C, H, hd) — pre-O-projection, k_cache, v_cache, k_scale,
    v_scale)."""
    c = q.shape[1]
    pos = (start.to(torch.int32)[:, None]
           + torch.arange(c, dtype=torch.int32, device=start.device)[None])
    q, k = _rope(cfg, q, k, pos, positions3)
    if k_scale is not None:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        k_cache = splice_rows(k_cache, kq, start)
        v_cache = splice_rows(v_cache, vq, start)
        k_scale = splice_rows(k_scale, ks, start)
        v_scale = splice_rows(v_scale, vs, start)
    else:
        k_cache = splice_rows(k_cache, k, start)
        v_cache = splice_rows(v_cache, v, start)
    out = L.attention_prefill(q, k_cache, v_cache, pos,
                              k_scale=k_scale, v_scale=v_scale)
    return out, k_cache, v_cache, k_scale, v_scale


def attn_prefill_apply(cfg: ModelConfig, p, x, k_cache, v_cache, start,
                       k_scale=None, v_scale=None, *, positions3=None):
    """Chunked prefill through the dense attention weights ``p``.
    Returns (out (B, C, D), k_cache, v_cache, k_scale, v_scale)."""
    tr = get_tracer()
    b, c, _ = x.shape
    with tr.span("attn.qkv", cat="forward"):
        q, k, v = _qkv(cfg, p, x)
    with tr.span("attn.core", cat="forward"):
        out, k_cache, v_cache, k_scale, v_scale = attn_prefill_core(
            cfg, q, k, v, k_cache, v_cache, start, k_scale, v_scale,
            positions3=positions3)
    with tr.span("attn.out", cat="forward"):
        out = L.dense(out.reshape(b, c, cfg.n_heads * cfg.hd), p["wo"])
    return out, k_cache, v_cache, k_scale, v_scale


def mlp_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.gated_mlp:
        return L.mlp_gated(x, p["w_gate"], p["w_up"], p["w_down"],
                           cfg.activation)
    return L.mlp_relu2(x, p["w_up"], p["w_down"], cfg.activation)


def layer_slice(tree: dict, i) -> dict:
    """Index every leaf of a stacked params (or cache) tree by ``i``."""
    return {k: (layer_slice(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def layer_list(tree: dict, n: int) -> list:
    """The ``n`` per-layer trees of a stacked tree, each leaf ``unbind``
    once: the same values as ``layer_slice``, and under autograd one
    ``stack`` in the backward where ``n`` indexings would each add a
    zero tensor the size of the whole stacked leaf."""
    out = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = layer_list(v, n) if isinstance(v, dict) else v.unbind(0)
        for d, part in zip(out, parts):
            d[k] = part
    return out


def remat_wrap(cfg: ModelConfig, fn):
    """``fn`` under the config's rematerialisation policy, as the
    reference wraps a scan body:

    - ``"none"``: ``fn`` itself;
    - ``"full"``: ``torch.utils.checkpoint`` (non-reentrant), which keeps
      the body's inputs and recomputes the rest in the backward;
    - ``"dots"``: the reference's ``checkpoint_dots_with_no_batch_dims``
      as a selective checkpoint: the outputs of ``aten.mm`` / ``aten.addmm``
      (the projections, products without batch dims) are saved, the rest
      (``bmm`` included: attention's batched products) recomputed.

    Recomputation repeats the same ops on the same inputs, so every
    output and gradient bit is the same under the three policies.
    Non-reentrant checkpointing runs the body with grad mode as it is,
    so ``layers.flash_attention`` takes its differentiable path in the
    forward and in the recompute alike."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        context_fn = None
    elif cfg.remat == "dots":
        context_fn = _dots_contexts
    else:
        raise ValueError(f"unknown remat policy {cfg.remat!r}")

    def wrapped(*args):
        if not torch.is_grad_enabled():     # nothing to save or recompute
            return fn(*args)
        kw = {} if context_fn is None else {"context_fn": context_fn}
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


def _dots_policy(ctx, op, *args, **kwargs):
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


def forward(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Train / prefill forward: tokens (B, S) [+ positions (B, S)] ->
    logits (B, S, V); the VLM flavour also takes ``positions3`` (3, B, S)
    and ``embeddings`` (B, S, D) spliced over the token embeddings where
    ``vis_mask`` (B, S) is set."""
    tokens = batch["tokens"].to(params["embed"].device)
    b, s = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    positions3 = batch.get("positions3")
    h = embed_tokens(cfg, params, tokens)
    if "embeddings" in batch:
        vis = batch["embeddings"].to(h.dtype)
        h = torch.where(batch["vis_mask"][..., None], vis, h)

    def body(h, lp):
        h = h + attn_apply(cfg, lp["attn"], _norm(cfg, lp["ln1"], h),
                           positions, positions3=positions3)
        return h + mlp_apply(cfg, lp["mlp"], _norm(cfg, lp["ln2"], h))

    body = remat_wrap(cfg, body)
    for lp in layer_list(params["layers"], cfg.n_layers):
        h = body(h, lp)
    return logits_from_hidden(cfg, params, h)


def _layer_loop(cfg: ModelConfig, params: dict, cache: dict, h, attn,
                mlp=None):
    """The layer loop of ``decode_step`` and ``prefill_chunk`` (a Python
    loop over the stacked leaves, in place of the reference's scan).
    ``attn(p, hn, kc, vc, ks, vs)`` is the attention apply with the
    cache's positions bound; ``mlp(lp, hn)`` the feed-forward block (the
    dense MLP unless given: the MoE family passes its own); returns (h,
    {leaf: stacked new cache}).  Traced by layer group: ``layer.slice``,
    ``attn`` (norm, the attention's ``attn.qkv`` / ``attn.core`` /
    ``attn.out``, residual), ``mlp`` (norm, MLP, residual), then
    ``cache.stack``."""
    if mlp is None:
        def mlp(lp, hn):
            return mlp_apply(cfg, lp["mlp"], hn)
    tr = get_tracer()
    names = [n for n in ("k", "v", "k_scale", "v_scale") if n in cache]
    new = {n: [] for n in names}
    for i in range(cfg.n_layers):
        with tr.span("layer.slice", cat="forward"):
            lp = layer_slice(params["layers"], i)
            kv = [cache[n][i] for n in names] + [None] * (4 - len(names))
        with tr.span("attn", cat="forward"):
            a, *kv = attn(lp["attn"], _norm(cfg, lp["ln1"], h), *kv)
            h = h + a
        with tr.span("mlp", cat="forward"):
            h = h + mlp(lp, _norm(cfg, lp["ln2"], h))
        for n, t in zip(names, kv):
            new[n].append(t)
    with tr.span("cache.stack", cat="forward"):
        return h, {n: torch.stack(ts) for n, ts in new.items()}


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    """One dense decode step: tokens (B, 1) -> logits (B, 1, V) and a new
    cache (the input cache is not modified; ``len`` advances by one).
    Runs where ``params`` live."""
    tr = get_tracer()
    with tr.span("embed", cat="forward"):
        tokens = batch["tokens"].to(params["embed"].device)
        h = embed_tokens(cfg, params, tokens)
    positions3 = batch.get("positions3")

    def attn(p, hn, kc, vc, ks, vs):
        return attn_decode_apply(cfg, p, hn, kc, vc, cache["len"], ks, vs,
                                 positions3=positions3)

    h, new = _layer_loop(cfg, params, cache, h, attn)
    new["len"] = cache["len"] + 1
    with tr.span("lm_head", cat="forward"):
        return logits_from_hidden(cfg, params, h), new


def prefill_chunk(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    """One dense chunked-prefill step: tokens (B, C) land at positions
    cache["len"]..cache["len"]+C-1; ``batch["n_valid"]`` (B,) marks the
    real tokens of a padded final chunk and ``len`` advances by it only.
    Returns full-chunk logits (B, C, V) and the new cache."""
    tr = get_tracer()
    start = cache["len"]
    with tr.span("embed", cat="forward"):
        tokens = batch["tokens"].to(params["embed"].device)
        n_valid = batch.get("n_valid")
        if n_valid is None:
            n_valid = torch.full_like(start, tokens.shape[1])
        h = embed_tokens(cfg, params, tokens)
    positions3 = batch.get("positions3")

    def attn(p, hn, kc, vc, ks, vs):
        return attn_prefill_apply(cfg, p, hn, kc, vc, start, ks, vs,
                                  positions3=positions3)

    h, new = _layer_loop(cfg, params, cache, h, attn)
    new["len"] = start + n_valid.to(start.device)
    with tr.span("lm_head", cat="forward"):
        return logits_from_hidden(cfg, params, h), new


# --------------------------------------------------------------------------
# the dense family (and VLM, MoE) on a mesh: each rank's shards, explicit
# collectives
# --------------------------------------------------------------------------
def tp_widths(cfg: ModelConfig) -> tuple:
    """The dims the dense family's sharded steps split on ``model``: the
    padded vocab, the ffn width and the q / kv widths (each family module
    has its own ``tp_widths``; ``factory.shards`` asks it)."""
    return (cfg.padded_vocab, cfg.d_ff, cfg.n_heads * cfg.hd,
            cfg.n_kv_heads * cfg.hd)


def _model_part(mesh, width: int) -> tuple:
    """The columns [lo, hi) of a ``width`` split over ``model`` that this
    rank holds."""
    tp = P.mesh_axis_size(mesh, "model")
    r = P.axis_index(mesh, "model")
    return r * width // tp, (r + 1) * width // tp


def _columns(x, have: tuple, want: tuple, width: int, mesh):
    """An activation holding columns ``have`` of ``width`` on its last dim
    (all of them, or this rank's ``model`` part) -> columns ``want``:
    sliced where it holds them, else all-gathered along ``model`` first
    (whose backward reduce-scatters the ranks' partial gradients)."""
    if have == want:
        return x
    if not (have[0] <= want[0] and want[1] <= have[1]):
        x = P.gather_dim(x, x.dim() - 1, mesh, "model")
        have = (0, width)
    return x[..., want[0] - have[0]:want[1] - have[0]]


def attn_heads(cfg: ModelConfig, mesh) -> tuple:
    """The q heads [lo, hi) this rank's attention runs under tensor
    parallelism: its ``n_heads / model`` where that divides, else all of
    them (replicated over ``model``).  On a 16-way ``model`` axis:
    granite-3-2b runs 2 of 32 heads, nemotron-4-15b 3 of 48 and
    qwen1.5-110b 4 of 64, each with one KV head gathered along ``model``
    (8 KV heads give a rank half of one); llama7b-espim runs 2 of 32
    with its own 2 KV heads; qwen2.5-14b's 40 heads do not divide 16, so
    its attention runs on all 40 on every rank."""
    tp = P.mesh_axis_size(mesh, "model")
    if cfg.n_heads % tp:
        return 0, cfg.n_heads
    return _model_part(mesh, cfg.n_heads)


def _attn_tp(cfg: ModelConfig, p: dict, x, positions, mesh,
             positions3=None, *, causal: bool = True, kv_x=None):
    """Tensor-parallel attention: ``x`` (B, S, D) inside the region
    (``copy_to``); wq / wk / wv (+ biases) this rank's output columns, wo
    its rows.  q, k and v are resharded to the heads this rank's
    attention runs (``attn_heads``; their KV heads h // n_rep), gathered
    along ``model`` where a shard holds no whole head; M-RoPE where
    ``positions3`` (3, B, S) is given.  ``kv_x`` (B, T, D), inside the
    region too, makes it cross-attention (k / v from it, no RoPE), as
    ``attn_apply``'s.  Returns this rank's partial of the output
    projection summed over ``model``."""
    b, s, _ = x.shape
    hd, n_q, n_kv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    n_rep = n_q // n_kv
    h_lo, h_hi = attn_heads(cfg, mesh)
    kv_lo, kv_hi = h_lo // n_rep, (h_hi - 1) // n_rep + 1
    q_w, kv_w = n_q * hd, n_kv * hd

    def heads(src, w, bias, width, lo, hi):
        y = _columns(L.dense(src, w, bias), _model_part(mesh, width),
                     (lo * hd, hi * hd), width, mesh)
        return y.reshape(b, src.shape[1], hi - lo, hd)

    src = x if kv_x is None else kv_x
    q = heads(x, p["wq"], p.get("bq"), q_w, h_lo, h_hi)
    k = heads(src, p["wk"], p.get("bk"), kv_w, kv_lo, kv_hi)
    v = heads(src, p["wv"], p.get("bv"), kv_w, kv_lo, kv_hi)
    if kv_x is None:
        q, k = _rope(cfg, q, k, positions, positions3)
    n_h, n_k = h_hi - h_lo, kv_hi - kv_lo
    idx = [h // n_rep - kv_lo for h in range(h_lo, h_hi)]
    if n_h % n_k or idx != [j // (n_h // n_k) for j in range(n_h)]:
        # the local q heads do not share their KV heads in equal runs:
        # one KV head per q head
        sel = torch.tensor(idx, device=k.device)
        k, v = k[:, :, sel], v[:, :, sel]
    out = L.flash_attention(q, k, v, causal=causal, q_chunk=cfg.q_chunk,
                            kv_chunk=cfg.kv_chunk)
    out = _columns(out.reshape(b, s, n_h * hd), (h_lo * hd, h_hi * hd),
                   _model_part(mesh, q_w), q_w, mesh)
    return P.reduce_from(L.dense(out, p["wo"]), mesh)


def _vocab_rows(embed, tokens, mesh, axis):
    """The rows of ``tokens`` that this rank's vocab shard ``embed`` (split
    on ``axis``) holds, the others' tokens as zero rows."""
    n = embed.shape[0]
    idx = tokens.long() - P.axis_index(mesh, axis) * n
    own = (idx >= 0) & (idx < n)
    rows = embed[torch.where(own, idx, torch.zeros_like(idx))]
    return torch.where(own[..., None], rows, torch.zeros_like(rows))


def _embed_tp(cfg: ModelConfig, embed, tokens, mesh):
    """The vocab-parallel lookup: this rank's rows of the embedding
    (split on ``model``), the others' tokens masked to zero, summed over
    ``model``."""
    if P.mesh_axis_size(mesh, "model") == 1:
        return embed_tokens(cfg, {"embed": embed}, tokens)
    return P.reduce_from(_vocab_rows(embed, tokens, mesh, "model"),
                         mesh).to(cfg.cdtype)


def forward_sharded(cfg: ModelConfig, params: dict, batch: dict,
                    layout) -> torch.Tensor:
    """The dense forward on this rank's shards, the reference's SPMD
    layout written out: ``params`` are the local tensors of a tree placed
    by ``layout`` (``partition.Layout``: ``param_pspecs``, FSDP on
    ``data`` and TP on ``model``), ``batch`` this rank's part of the
    batch (with the VLM flavour's ``positions3`` (3, B, S) and
    ``embeddings`` / ``vis_mask``, as ``forward`` takes them).

      * ZeRO-3: each layer's params are all-gathered along ``data``
        inside the layer's body, just before use (``fsdp_gather``), so
        the body that ``remat_wrap`` checkpoints gathers again in the
        recompute, and the gathers' backward reduce-scatters the grads
        to their data shards as the mean over the data-parallel axes;
        embedding, final norm and lm_head likewise outside the loop.
      * TP: column-parallel wq / wk / wv / w_gate / w_up, row-parallel
        wo / w_down summed over ``model`` (``copy_to`` / ``reduce_from``
        around each block), attention on ``attn_heads``, a vocab-parallel
        embedding (the vision embeddings spliced over its sum), and the
        logits left split on ``model``.

    Returns this rank's logits (B_local, S, V / model).  Needs
    ``factory.shards``.  On a mesh of one rank every collective is skipped
    and the ops are ``forward``'s, bit for bit."""
    return _forward_sharded(cfg, params, batch, layout)[0]


def _forward_sharded(cfg: ModelConfig, params: dict, batch: dict, layout,
                     ffn=None):
    """``forward_sharded`` -> (logits, the sum over the layers of the
    feed-forward blocks' aux terms): ``ffn(lp, x) -> (y, aux or None)``
    is the block on a layer's gathered params and ``x`` inside the
    region, ``y`` summed over ``model`` (the dense MLP unless given: the
    MoE family passes its own)."""
    mesh, specs = layout.mesh, layout.specs

    if ffn is None:
        def ffn(lp, x):
            return P.reduce_from(mlp_apply(cfg, lp["mlp"], x), mesh), None

    tokens = batch["tokens"].to(params["embed"].device)
    b, s = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    positions3 = batch.get("positions3")
    embed = P.fsdp_gather(params["embed"], specs["embed"], mesh)
    h = _embed_tp(cfg, embed, tokens, mesh)
    if "embeddings" in batch:
        vis = batch["embeddings"].to(h.dtype)
        h = torch.where(batch["vis_mask"][..., None], vis, h)
    layer_specs = tree_map(lambda sp: sp[1:], specs["layers"])

    def body(h, aux, lp):
        lp = fsdp_tree(lp, layer_specs, mesh)
        x = P.copy_to(_norm(cfg, lp["ln1"], h), mesh)
        h = h + _attn_tp(cfg, lp["attn"], x, positions, mesh, positions3)
        x = P.copy_to(_norm(cfg, lp["ln2"], h), mesh)
        y, a = ffn(lp, x)
        return h + y, aux if a is None else aux + a

    body = remat_wrap(cfg, body)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp in layer_list(params["layers"], cfg.n_layers):
        h, aux = body(h, aux, lp)
    top = {"embed": embed,
           "final_norm": fsdp_tree(params["final_norm"], specs["final_norm"],
                                   mesh)}
    if "lm_head" in params:
        top["lm_head"] = P.fsdp_gather(params["lm_head"], specs["lm_head"],
                                       mesh)
    return logits_from_hidden(cfg, top, h, mesh), aux


def fsdp_tree(tree, spec, mesh):
    """``partition.fsdp_gather`` on every leaf of a params tree placed by
    the spec tree ``spec``: ZeRO-3's gather of a layer's params."""
    return tree_map(lambda t, sp: P.fsdp_gather(t, sp, mesh), tree, spec)


def gather_rows(x, mesh, b_ax, axes=None):
    """The rank-local batch ``x`` (B_local, ...) all-gathered along the
    axes ``axes`` of the batch's spec entry ``b_ax`` (all of them unless
    given; they must be its minor axes): the rows of every rank along
    them, in the global order."""
    take = P.axis_names(b_ax) if axes is None else axes
    spec = (b_ax,) + (None,) * (x.dim() - 1)
    return P.gather_along(x, spec, mesh, take)


def _row_axes(b_ax, axes) -> tuple:
    """The axes of the batch's spec entry ``b_ax`` that also split a
    weight dim placed on ``axes``: the ranks along them multiply one
    weight shard each, so they need each other's rows."""
    names = P.axis_names(axes)
    return tuple(a for a in P.axis_names(b_ax) if a in names)


def _mlp_tp(cfg: ModelConfig, p: dict, sp: dict, hn, mesh, b_ax):
    """The dense MLP on this rank's d_ff slice (``w_up`` / ``w_gate``
    columns and ``w_down`` rows, split on the same axes, (``data``,
    ``model``) at ``serve_param_pspecs``) of the rows gathered along the
    batch axes among them: the partial ``w_down`` products summed over
    those axes and left as this rank's rows (a reduce-scatter along the
    batch axes, an all-reduce along the others).  Where the contraction
    dim is split too (zamba2's shared MLP at ``global_batch == 1``: D on
    ``data``), the gate / up partials are summed over its axes before the
    activation and ``w_down``'s output columns gathered.  ``mlp_apply``
    on the local rows where no dim is split."""
    f_ax, d_ax, o_ax = sp["w_up"][-1], sp["w_up"][0], sp["w_down"][-1]
    if not P.sharded_axes((f_ax, d_ax, o_ax), mesh):
        return mlp_apply(cfg, p, hn)
    take = _row_axes(b_ax, f_ax)
    x = gather_rows(hn, mesh, b_ax, take)
    if P.sharded_axes((d_ax, o_ax), mesh):
        x = P.local_slice(x, (None, None, d_ax), mesh)
        names = ("w_gate", "w_up") if cfg.gated_mlp else ("w_up",)
        ys = P.all_reduce(torch.stack([L.dense(x, p[n]) for n in names]),
                          mesh, d_ax).unbind(0)
        act = L.act_fn(cfg.activation)
        a = act(ys[0]) * ys[1] if cfg.gated_mlp else act(ys[0])
        y = P.sum_to_shard(L.dense(a, p["w_down"]), mesh, f_ax, 0, take)
        return P.gather_along(y, (None, None, o_ax), mesh,
                              P.axis_names(o_ax))
    return P.sum_to_shard(mlp_apply(cfg, p, x), mesh, f_ax, 0, take)


def _columns_of(spec_entry, mesh, width: int) -> tuple:
    """The columns [lo, hi) of a ``width`` that a leaf dim placed on
    ``spec_entry`` (``model`` or None: the attention leaves) holds here."""
    if P.axis_names(spec_entry) == ("model",):
        return _model_part(mesh, width)
    if P.sharded_axes((spec_entry,), mesh):
        raise ValueError(f"an attention dim split on {spec_entry}")
    return 0, width


def _attn_decode_tp(cfg: ModelConfig, p: dict, sp: dict, hn, kc, vc, ks,
                    vs, lens, mesh, kv_heads: tuple, seq, positions3):
    """One decode token's attention on this rank's weight shards and its
    cache shard: the KV heads ``kv_heads`` = [lo, hi) (this rank's where
    the cache splits the heads on ``model``, else all of them over a
    sequence shard, ``seq``) and their q heads.

      * q / k / v: ``hn``'s columns narrowed to the rows of wq / wk / wv
        where their contraction dim is split (the ``global_batch == 1``
        layout: on ``data``), the three partial products summed over
        those axes in one all-reduce, the biases added; then each
        resharded to the heads this rank attends (``_columns``: a slice
        where the rank's column shard holds them, the Megatron case,
        else an all-gather of the activation along ``model``).
      * RoPE (M-RoPE with ``positions3``), the cache write on the rank
        that holds position ``len`` and the attention over the shard
        (``attn_decode_core``; a split sequence combines the ranks'
        partial softmax).
      * wo: the output's columns that match wo's local rows, times them,
        summed over the axes that split those rows; wo's output columns
        (split on ``data`` at ``global_batch == 1``) all-gathered.

    Returns (out (B, 1, D), kc, vc, ks, vs)."""
    b, hd = hn.shape[0], cfg.hd
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q_w, kv_w = cfg.n_heads * hd, cfg.n_kv_heads * hd
    kv_lo, kv_hi = kv_heads
    q_lo, q_hi = kv_lo * n_rep, kv_hi * n_rep
    yq, yk, yv = proj_tp(p, sp, [(hn, n) for n in ("wq", "wk", "wv")], mesh)
    q = heads_tp(cfg, p, sp, yq, "wq", q_w, q_lo, q_hi, mesh)
    k = heads_tp(cfg, p, sp, yk, "wk", kv_w, kv_lo, kv_hi, mesh)
    v = heads_tp(cfg, p, sp, yv, "wv", kv_w, kv_lo, kv_hi, mesh)
    out, kc, vc, ks, vs = attn_decode_core(
        cfg, q, k, v, kc, vc, lens, ks, vs, positions3=positions3, seq=seq)
    return out_tp(cfg, p, sp, out, (q_lo, q_hi), mesh), kc, vc, ks, vs


def proj_tp(p: dict, sp: dict, pairs, mesh) -> list:
    """The products of ``pairs`` ((x (B, S, every column), name), ...)
    with the local weights ``p[name]`` (specs in ``sp``, one contraction
    split): each x's columns narrowed to its weight's rows where the
    contraction dim is split (the ``global_batch == 1`` layout: on
    ``data``), the partial products summed over those axes in one
    all-reduce.  The products' columns stay the weights' local ones."""
    k_ax = sp[pairs[0][1]][0]
    ys = [L.dense(P.local_slice(x, (None, None, k_ax), mesh), p[n])
          for x, n in pairs]
    if P.mesh_axis_size(mesh, k_ax) > 1:
        widths = [y.shape[-1] for y in ys]
        ys = P.all_reduce(torch.cat(ys, -1), mesh, k_ax).split(widths, -1)
    return list(ys)


def heads_tp(cfg: ModelConfig, p: dict, sp: dict, y, name: str, width: int,
             lo: int, hi: int, mesh):
    """``proj_tp``'s product ``y`` of projection ``name`` (``width``
    columns, its local ones) plus its bias, resharded to heads [lo, hi)
    (``_columns``: a slice where the rank's column shard holds them,
    else an all-gather along ``model``): (B, S, hi - lo, hd)."""
    bias = p.get("b" + name[1])
    if bias is not None:
        y = y + bias.to(y.dtype)
    y = _columns(y, _columns_of(sp[name][-1], mesh, width),
                 (lo * cfg.hd, hi * cfg.hd), width, mesh)
    return y.reshape(y.shape[0], y.shape[1], hi - lo, cfg.hd)


def out_tp(cfg: ModelConfig, p: dict, sp: dict, out, heads: tuple, mesh):
    """The output projection of the attention ``out`` (B, S, H_local, hd)
    over q heads ``heads`` = [lo, hi): the columns that match wo's local
    rows, times them, summed over the axes that split those rows; wo's
    output columns (split on ``data`` at ``global_batch == 1``)
    all-gathered.  (B, S, D)."""
    b, s = out.shape[:2]
    q_w = cfg.n_heads * cfg.hd
    in_ax, out_ax = sp["wo"]
    out = _columns(out.reshape(b, s, (heads[1] - heads[0]) * cfg.hd),
                   (heads[0] * cfg.hd, heads[1] * cfg.hd),
                   _columns_of(in_ax, mesh, q_w), q_w, mesh)
    y = P.all_reduce(L.dense(out, p["wo"]), mesh, in_ax)
    return P.gather_along(y, (None, None, out_ax), mesh, P.axis_names(out_ax))


def decode_step_sharded(cfg: ModelConfig, params: dict, cache: dict,
                        batch: dict, playout, clayout, donate: bool = True,
                        ffn=None):
    """One dense decode step as tensor-parallel products on this rank's
    shards: ``params`` the local tensors of a tree placed by ``playout``
    (``serve_param_pspecs``: TP over (``data``, ``model``), at
    ``global_batch == 1`` the attention's contraction dim on ``data``
    too), ``cache`` by ``clayout`` (``cache_pspecs``: batch on the data
    axes, KV heads on ``model`` where they divide, else the sequence),
    ``batch`` this rank's tokens (B_local, 1) (and ``positions3`` (3,
    B_local, 1) for M-RoPE).

    No param leaf moves: each product follows its leaf's spec, and only
    activations do, at most B_global x the widest activation row a
    collective.
      * The embedding (V split): the tokens gathered along the batch axes
        that split V, a vocab-parallel lookup of the rank's rows, summed
        over V's axes and left as the local batch (``sum_to_shard``).
      * Attention on the local batch (``_attn_decode_tp``): the rank's
        KV heads and their q heads where the cache splits the heads,
        else every head over the rank's sequence shard; wo's rows summed
        over ``model``.
      * The feed-forward block, ``ffn(lp, sp, hn)`` on a layer's local
        params and their specs (the dense MLP's d_ff slice on the rows
        gathered along the batch axes, ``_mlp_tp``, unless given: the
        MoE family passes its own), returning the local batch's rows.
      * The logits: this rank's V shard of the rows gathered along the
        batch axes that split V.
    With ``donate`` the cache's K / V (and scale) leaves are written in
    place and returned; ``len`` is always a new tensor.  Returns (the
    logits (B_rows, 1, V_cols), the new local cache, the logits' spec:
    the axes that split their rows and their vocab, along which
    ``serve_step`` gathers them).  On one rank every collective is
    skipped and it is ``decode_step``, bit for bit."""
    mesh, ps, cs = playout.mesh, playout.specs, clayout.specs
    positions3 = batch.get("positions3")
    b_ax = cs["k"][1]
    if ffn is None:
        def ffn(lp, sp, hn):
            return _mlp_tp(cfg, lp["mlp"], sp["mlp"], hn, mesh, b_ax)

    h = decode_embed(cfg, params["embed"], ps["embed"][0], batch["tokens"],
                     mesh, b_ax)
    lens = P.local_slice(cache["len"], (b_ax,), mesh)
    lsp = tree_map(lambda sp: sp[1:], ps["layers"])
    attn = decode_attn(cfg, mesh, lsp["attn"], cs["k"], cache["k"].shape,
                       lens, positions3)
    names = [n for n in ("k", "v", "k_scale", "v_scale") if n in cache]
    new = {n: [] for n in names}
    for i in range(cfg.n_layers):
        lp = layer_slice(params["layers"], i)
        kv = [cache[n][i] for n in names] + [None] * (4 - len(names))
        a, *kv = attn(lp["attn"], _norm(cfg, lp["ln1"], h), *kv)
        h = h + a
        h = h + ffn(lp, lsp, _norm(cfg, lp["ln2"], h))
        for n, t in zip(names, kv):
            keep_row(cache[n], new[n], i, t, donate)
    out = stacked_rows(cache, new, donate)
    out["len"] = cache["len"] + 1
    logits, lspec = decode_logits(cfg, params, ps, h, mesh, b_ax)
    return logits, out, lspec


def keep_row(stacked, rows: list, i: int, t, donate: bool) -> None:
    """Layer ``i``'s new rows ``t`` of a stacked cache leaf: written into
    it in place with ``donate``, else kept in ``rows``."""
    if donate:
        stacked[i].copy_(t)
    else:
        rows.append(t)


def stacked_rows(cache: dict, new: dict, donate: bool) -> dict:
    """The new stacked leaves of ``keep_row``'s rows: the cache's own
    leaves with ``donate``, else each leaf's rows stacked."""
    return {n: cache[n] if donate else torch.stack(ts)
            for n, ts in new.items()}


def decode_embed(cfg: ModelConfig, table, e_ax, ids, mesh, b_ax):
    """The rows of a table split on ``e_ax`` along its rows (an embedding
    at ``serve_param_pspecs``: V on (``data``, ``model``); whisper's
    learned positions) for this rank's ids (B_local, S): the ids gathered
    along the batch axes that split the table, a lookup of the rank's
    rows (``_vocab_rows``), summed over the table's axes and left as the
    local batch (``sum_to_shard``), in the compute dtype."""
    ids = ids.to(table.device)
    if not P.sharded_axes((e_ax,), mesh):
        return embed_tokens(cfg, {"embed": table}, ids)
    take = _row_axes(b_ax, e_ax)
    rows = _vocab_rows(table, gather_rows(ids, mesh, b_ax, take), mesh, e_ax)
    return P.sum_to_shard(rows, mesh, e_ax, 0, take).to(cfg.cdtype)


def decode_attn(cfg: ModelConfig, mesh, asp: dict, k_spec, k_shape, lens,
                positions3=None):
    """``attn(p, hn, kc, vc, ks, vs)`` -> (out, kc, vc, ks, vs): one decode
    token's self-attention on a layer's local weights ``p`` (specs
    ``asp``) and its cache shards, the stacked K cache placed by
    ``k_spec`` (layers, batch, sequence, KV heads, hd) with local shape
    ``k_shape``: ``_attn_decode_tp`` on the rank's KV heads or sequence
    shard, ``attn_decode_apply`` where nothing is split."""
    _, _, s_ax, kv_ax = k_spec[:4]
    seq = None
    if P.mesh_axis_size(mesh, s_ax) > 1:
        seq = (P.axis_index(mesh, s_ax) * k_shape[2],
               lambda t: P.all_reduce(t, mesh, s_ax, "max"),
               lambda t: P.all_reduce(t, mesh, s_ax))
    n_kv = k_shape[3]
    kv_lo = P.axis_index(mesh, kv_ax) * n_kv
    whole = (seq is None and P.mesh_axis_size(mesh, kv_ax) == 1
             and not any(P.sharded_axes(sp, mesh) for _, sp in flatten(asp)))

    def attn(p, hn, kc, vc, ks=None, vs=None):
        if whole:
            return attn_decode_apply(cfg, p, hn, kc, vc, lens, ks, vs,
                                     positions3=positions3)
        return _attn_decode_tp(cfg, p, asp, hn, kc, vc, ks, vs, lens, mesh,
                               (kv_lo, kv_lo + n_kv), seq, positions3)

    return attn


def decode_logits(cfg: ModelConfig, params: dict, ps: dict, h, mesh, b_ax):
    """(this rank's logits, their spec) of a decode step's last hidden
    state ``h`` (the local batch): the final norm, then the tied
    embedding or the lm_head on this rank's V shard for the rows
    gathered along the batch axes that split V; the rows stay split
    along the batch axes not gathered."""
    head = "embed" if cfg.tie_embeddings else "lm_head"
    v_ax = ps[head][0 if cfg.tie_embeddings else -1]
    take = _row_axes(b_ax, v_ax)
    top = {"final_norm": params["final_norm"], head: params[head]}
    logits = logits_from_hidden(cfg, top, gather_rows(h, mesh, b_ax, take))
    left = tuple(a for a in P.axis_names(b_ax) if a not in take)
    rows = None if not left else left[0] if len(left) == 1 else left
    return logits, (rows, None, v_ax)
