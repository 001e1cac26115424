"""Whisper-small — the encoder-decoder audio transformer, backbone only
(mirrors ``src/repro/models/whisper.py``).

The conv frontend is a stub, as in the reference: a batch carries
precomputed frame embeddings (B, T_enc, D).  Encoder: bidirectional
self-attention with sinusoidal positions (``layers.flash_attention``, so
kernel 8 on the card, not causal).  Decoder: causal self-attention and
cross-attention with learned positions; LayerNorm and non-gated GELU
MLPs throughout; the output embedding tied.  ``prime_cross`` runs the
encoder once and writes every decoder layer's cross-attention K / V into
the cache, so decode-time cross-attention reads the cache only.

On a mesh (``forward_sharded``, ``decode_step_sharded``,
``prime_cross_sharded``) the blocks take the dense family's
tensor-parallel functions; 12 heads do not divide a 16-way ``model``
axis, so there attention runs on every head on every rank (q / k / v
gathered along ``model``), and the caches split along their sequence
(self) or stay whole over ``model`` (cross, 1500 frames).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import partition as P
from repro_torch.tree import tree_map

__all__ = ["init_params", "forward", "encode", "init_cache", "prime_cross",
           "decode_step", "forward_sharded", "decode_step_sharded",
           "prime_cross_sharded", "tp_widths"]

MAX_POS = 32768                 # rows of the learned decoder positions
tp_widths = T.tp_widths


def _sinusoid(n_pos: int, d: int) -> np.ndarray:
    pos = np.arange(n_pos)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    out = np.zeros((n_pos, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, max_pos: int = MAX_POS) -> dict:
    dev = resolve_device(device)
    gen = T._generator(generator, dev)
    ne, nd = (cfg.encoder_layers,), (cfg.n_layers,)
    return {
        "embed": T.normal(gen, (cfg.padded_vocab, cfg.d_model), 0.02,
                          cfg.dtype, dev),
        "pos_embed": T.normal(gen, (max_pos, cfg.d_model), 0.02, cfg.dtype,
                              dev),
        "enc_layers": {"ln1": T.init_norm(cfg, ne, dev),
                       "attn": T.init_attn_layer(cfg, gen, ne, dev),
                       "ln2": T.init_norm(cfg, ne, dev),
                       "mlp": T.init_mlp_layer(cfg, gen, ne, dev)},
        "enc_norm": T.init_norm(cfg, (), dev),
        "dec_layers": {"ln1": T.init_norm(cfg, nd, dev),
                       "self_attn": T.init_attn_layer(cfg, gen, nd, dev),
                       "ln_cross": T.init_norm(cfg, nd, dev),
                       "cross_attn": T.init_attn_layer(cfg, gen, nd, dev),
                       "ln2": T.init_norm(cfg, nd, dev),
                       "mlp": T.init_mlp_layer(cfg, gen, nd, dev)},
        "final_norm": T.init_norm(cfg, (), dev),
    }


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames (B, T_enc, D), the stub frontend's output -> encoder
    states (B, T_enc, D)."""
    frames = frames.to(params["embed"].device)
    b, t, d = frames.shape
    sin = torch.from_numpy(_sinusoid(t, d)).to(frames.device, cfg.cdtype)
    h = frames.to(cfg.cdtype) + sin[None]
    positions = torch.arange(t, dtype=torch.int32,
                             device=frames.device).expand(b, t)

    def body(h, lp):
        h = h + T.attn_apply(cfg, lp["attn"], T._norm(cfg, lp["ln1"], h),
                             positions, causal=False)
        return h + T.mlp_apply(cfg, lp["mlp"], T._norm(cfg, lp["ln2"], h))

    body = T.remat_wrap(cfg, body)
    for lp in T.layer_list(params["enc_layers"], cfg.encoder_layers):
        h = body(h, lp)
    return T._norm(cfg, params["enc_norm"], h)


def _embed(cfg: ModelConfig, params: dict, tokens, pos) -> torch.Tensor:
    """Token embedding plus the learned position rows ``pos``."""
    return (T.embed_tokens(cfg, params, tokens)
            + params["pos_embed"][pos.long()].to(cfg.cdtype))


def forward(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Teacher-forced decode over the whole target sequence: frames
    (B, T_enc, D), tokens (B, S) -> logits (B, S, V)."""
    enc = encode(cfg, params, batch["frames"])
    tokens = batch["tokens"].to(enc.device)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=enc.device).expand(b, s)
    h = _embed(cfg, params, tokens, positions[:1])

    def body(h, lp):
        h = h + T.attn_apply(cfg, lp["self_attn"],
                             T._norm(cfg, lp["ln1"], h), positions)
        h = h + T.attn_apply(cfg, lp["cross_attn"],
                             T._norm(cfg, lp["ln_cross"], h), positions,
                             causal=False, kv_x=enc)
        return h + T.mlp_apply(cfg, lp["mlp"], T._norm(cfg, lp["ln2"], h))

    body = T.remat_wrap(cfg, body)
    for lp in T.layer_list(params["dec_layers"], cfg.n_layers):
        h = body(h, lp)
    return T.logits_from_hidden(cfg, params, h)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device=None) -> dict:
    """Self-attention K / V (L, B, max_len, KV, hd), the cross-attention
    ``cross_k`` / ``cross_v`` (L, B, encoder_seq, KV, hd), all zero in the
    compute dtype."""
    dev = resolve_device(device)
    kv = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.hd)
    cross = (cfg.n_layers, batch_size, cfg.encoder_seq, cfg.n_kv_heads,
             cfg.hd)
    return {"k": torch.zeros(kv, dtype=cfg.cdtype, device=dev),
            "v": torch.zeros(kv, dtype=cfg.cdtype, device=dev),
            "cross_k": torch.zeros(cross, dtype=cfg.cdtype, device=dev),
            "cross_v": torch.zeros(cross, dtype=cfg.cdtype, device=dev),
            "len": torch.zeros((batch_size,), dtype=torch.int32,
                               device=dev)}


def prime_cross(cfg: ModelConfig, params: dict, cache: dict,
                frames: torch.Tensor) -> dict:
    """Run the encoder once and write every decoder layer's cross K / V
    into a copy of ``cache``."""
    enc = encode(cfg, params, frames)
    b, t, _ = enc.shape
    p = params["dec_layers"]["cross_attn"]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        ks.append(L.dense(enc, p["wk"][i], p["bk"][i] if "bk" in p else None
                          ).reshape(b, t, cfg.n_kv_heads, cfg.hd))
        vs.append(L.dense(enc, p["wv"][i], p["bv"][i] if "bv" in p else None
                          ).reshape(b, t, cfg.n_kv_heads, cfg.hd))
    return {**cache, "cross_k": torch.stack(ks), "cross_v": torch.stack(vs)}


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    """One decode step: tokens (B, 1) -> logits (B, 1, V) and a new cache;
    cross-attention runs over the whole encoder length of the cache."""
    tokens = batch["tokens"].to(params["embed"].device)
    b = tokens.shape[0]
    pos = cache["len"]
    h = _embed(cfg, params, tokens,
               torch.clamp(pos, 0, params["pos_embed"].shape[0] - 1)[:, None])
    t_enc = torch.full((b,), cache["cross_k"].shape[2], dtype=torch.int32,
                       device=h.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = T.layer_slice(params["dec_layers"], i)
        a, kc, vc, _, _ = T.attn_decode_apply(
            cfg, lp["self_attn"], T._norm(cfg, lp["ln1"], h),
            cache["k"][i], cache["v"][i], pos)
        h = h + a
        p = lp["cross_attn"]
        hn = T._norm(cfg, lp["ln_cross"], h)
        q = L.dense(hn, p["wq"], p.get("bq")).reshape(b, 1, cfg.n_heads,
                                                      cfg.hd)
        x = L.attention_decode(q, cache["cross_k"][i], cache["cross_v"][i],
                               t_enc)
        h = h + L.dense(x.reshape(b, 1, cfg.n_heads * cfg.hd), p["wo"])
        h = h + T.mlp_apply(cfg, lp["mlp"], T._norm(cfg, lp["ln2"], h))
        ks.append(kc)
        vs.append(vc)
    return T.logits_from_hidden(cfg, params, h), {
        **cache, "k": torch.stack(ks), "v": torch.stack(vs),
        "len": cache["len"] + 1}


# --------------------------------------------------------------------------
# whisper on a mesh: each rank's shards, explicit collectives
# --------------------------------------------------------------------------
def _encode_sharded(cfg: ModelConfig, params: dict, specs: dict, frames,
                    mesh) -> torch.Tensor:
    """``encode`` on this rank's shards in training (FSDP on ``data`` inside
    each layer's remat unit, the dense family's ``_attn_tp``, not causal,
    and a column / row-parallel MLP) for this rank's frames."""
    frames = frames.to(params["embed"].device)
    b, t, d = frames.shape
    sin = torch.from_numpy(_sinusoid(t, d)).to(frames.device, cfg.cdtype)
    h = frames.to(cfg.cdtype) + sin[None]
    positions = torch.arange(t, dtype=torch.int32,
                             device=frames.device).expand(b, t)
    lsp = tree_map(lambda sp: sp[1:], specs["enc_layers"])

    def body(h, lp):
        lp = T.fsdp_tree(lp, lsp, mesh)
        x = P.copy_to(T._norm(cfg, lp["ln1"], h), mesh)
        h = h + T._attn_tp(cfg, lp["attn"], x, positions, mesh,
                           causal=False)
        x = P.copy_to(T._norm(cfg, lp["ln2"], h), mesh)
        return h + P.reduce_from(T.mlp_apply(cfg, lp["mlp"], x), mesh)

    body = T.remat_wrap(cfg, body)
    for lp in T.layer_list(params["enc_layers"], cfg.encoder_layers):
        h = body(h, lp)
    return T._norm(cfg, T.fsdp_tree(params["enc_norm"], specs["enc_norm"],
                                    mesh), h)


def forward_sharded(cfg: ModelConfig, params: dict, batch: dict,
                    layout) -> torch.Tensor:
    """``forward`` on this rank's shards (``params`` placed by ``layout``:
    ``param_pspecs``, FSDP on ``data``, TP on ``model``; ``batch`` this
    rank's part, its ``frames`` (B_local, T_enc, D) on the batch axes):
    the encoder (``_encode_sharded``), then the decoder's causal
    self-attention and cross-attention on the encoder states (the dense
    family's ``_attn_tp``; the encoder states enter the region once),
    the column / row-parallel MLP, a vocab-parallel embedding, the
    learned positions looked up as the vocab is (their rows split on
    ``model``), and the tied logits left split on ``model``.  Returns
    this rank's logits (B_local, S, V / model); on one rank ``forward``,
    bit for bit."""
    mesh, specs = layout.mesh, layout.specs
    enc = P.copy_to(_encode_sharded(cfg, params, specs, batch["frames"],
                                    mesh), mesh)
    tokens = batch["tokens"].to(enc.device)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=enc.device).expand(b, s)
    embed = P.fsdp_gather(params["embed"], specs["embed"], mesh)
    pos_embed = P.fsdp_gather(params["pos_embed"], specs["pos_embed"], mesh)
    h = (T._embed_tp(cfg, embed, tokens, mesh)
         + T._embed_tp(cfg, pos_embed, positions[:1], mesh))
    lsp = tree_map(lambda sp: sp[1:], specs["dec_layers"])

    def body(h, lp):
        lp = T.fsdp_tree(lp, lsp, mesh)
        x = P.copy_to(T._norm(cfg, lp["ln1"], h), mesh)
        h = h + T._attn_tp(cfg, lp["self_attn"], x, positions, mesh)
        x = P.copy_to(T._norm(cfg, lp["ln_cross"], h), mesh)
        h = h + T._attn_tp(cfg, lp["cross_attn"], x, positions, mesh,
                           causal=False, kv_x=enc)
        x = P.copy_to(T._norm(cfg, lp["ln2"], h), mesh)
        return h + P.reduce_from(T.mlp_apply(cfg, lp["mlp"], x), mesh)

    body = T.remat_wrap(cfg, body)
    for lp in T.layer_list(params["dec_layers"], cfg.n_layers):
        h = body(h, lp)
    top = {"embed": embed,
           "final_norm": T.fsdp_tree(params["final_norm"],
                                     specs["final_norm"], mesh)}
    return T.logits_from_hidden(cfg, top, h, mesh)


def _attn_full_tp(cfg: ModelConfig, p: dict, sp: dict, x, mesh):
    """Bidirectional attention over a whole sequence on this rank's weight
    shards at the serving layout, no grad (the encoder's in
    ``prime_cross_sharded``): ``transformer.proj_tp`` / ``heads_tp`` to
    the heads of ``attn_heads``, ``layers.flash_attention``, then
    ``out_tp``."""
    lo, hi = T.attn_heads(cfg, mesh)
    w = cfg.n_heads * cfg.hd
    ys = T.proj_tp(p, sp, [(x, n) for n in ("wq", "wk", "wv")], mesh)
    q, k, v = (T.heads_tp(cfg, p, sp, y, n, w, lo, hi, mesh)
               for y, n in zip(ys, ("wq", "wk", "wv")))
    out = L.flash_attention(q, k, v, causal=False, q_chunk=cfg.q_chunk,
                            kv_chunk=cfg.kv_chunk)
    return T.out_tp(cfg, p, sp, out, (lo, hi), mesh)


def prime_cross_sharded(cfg: ModelConfig, params: dict, cache: dict,
                        frames: torch.Tensor, playout, clayout) -> dict:
    """``prime_cross`` on this rank's shards: ``params`` and ``cache`` the
    local tensors of trees placed by ``playout`` (``serve_param_pspecs``)
    and ``clayout`` (``cache_pspecs``), ``frames`` this rank's rows
    (B_local, T_enc, D).  The encoder runs as tensor-parallel products
    (no param leaf gathered: ``_attn_full_tp`` and the dense family's
    MLP on the rows gathered along the batch axes that split d_ff), then
    each decoder layer's cross K / V on the rank's ``wk`` / ``wv``
    columns, resharded to the cache's KV heads and sliced to its frames.
    Returns a copy of ``cache`` with this rank's shards of ``cross_k`` /
    ``cross_v``."""
    mesh, ps, cs = playout.mesh, playout.specs, clayout.specs
    b_ax = cs["cross_k"][1]
    frames = frames.to(params["embed"].device)
    b, t, d = frames.shape
    sin = torch.from_numpy(_sinusoid(t, d)).to(frames.device, cfg.cdtype)
    h = frames.to(cfg.cdtype) + sin[None]
    esp = tree_map(lambda sp: sp[1:], ps["enc_layers"])
    for i in range(cfg.encoder_layers):
        lp = T.layer_slice(params["enc_layers"], i)
        h = h + _attn_full_tp(cfg, lp["attn"], esp["attn"],
                              T._norm(cfg, lp["ln1"], h), mesh)
        h = h + T._mlp_tp(cfg, lp["mlp"], esp["mlp"],
                          T._norm(cfg, lp["ln2"], h), mesh, b_ax)
    enc = T._norm(cfg, params["enc_norm"], h)
    csp = tree_map(lambda sp: sp[1:], ps["dec_layers"]["cross_attn"])
    _, _, t_ax, kv_ax = cs["cross_k"][:4]
    n_kv = cache["cross_k"].shape[3]
    kv_lo = P.axis_index(mesh, kv_ax) * n_kv
    kv_w = cfg.n_kv_heads * cfg.hd
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p = T.layer_slice(params["dec_layers"]["cross_attn"], i)
        yk, yv = T.proj_tp(p, csp, ((enc, "wk"), (enc, "wv")), mesh)
        for y, n, out in ((yk, "wk", ks), (yv, "wv", vs)):
            y = T.heads_tp(cfg, p, csp, y, n, kv_w, kv_lo, kv_lo + n_kv,
                           mesh)
            out.append(P.local_slice(y, (None, t_ax), mesh))
    return {**cache, "cross_k": torch.stack(ks), "cross_v": torch.stack(vs)}


def _cross_decode_tp(cfg: ModelConfig, p: dict, sp: dict, hn, ck, cv,
                     c_spec, t_enc: int, mesh):
    """One decode token's cross-attention on this rank's weight shards
    over its shard of the cross K / V cache (placed by ``c_spec``: its
    KV heads on ``model`` where they divide, else its frames where they
    divide, else whole): q on the rank's wq columns resharded to the q
    heads of the cache's KV heads, the attention (a frame split combines
    the ranks' partial softmax), then ``out_tp``."""
    _, _, t_ax, kv_ax = c_spec[:4]
    seq = None
    if P.mesh_axis_size(mesh, t_ax) > 1:
        seq = (P.axis_index(mesh, t_ax) * ck.shape[1],
               lambda t: P.all_reduce(t, mesh, t_ax, "max"),
               lambda t: P.all_reduce(t, mesh, t_ax))
    n_rep = cfg.n_heads // cfg.n_kv_heads
    kv_lo = P.axis_index(mesh, kv_ax) * ck.shape[2]
    q_lo, q_hi = kv_lo * n_rep, (kv_lo + ck.shape[2]) * n_rep
    (yq,) = T.proj_tp(p, sp, ((hn, "wq"),), mesh)
    q = T.heads_tp(cfg, p, sp, yq, "wq", cfg.n_heads * cfg.hd, q_lo, q_hi,
                   mesh)
    lens = torch.full((hn.shape[0],), t_enc, dtype=torch.int32,
                      device=hn.device)
    x = L.attention_decode(q, ck, cv, lens, seq=seq)
    return T.out_tp(cfg, p, sp, x, (q_lo, q_hi), mesh)


def decode_step_sharded(cfg: ModelConfig, params: dict, cache: dict,
                        batch: dict, playout, clayout, donate: bool = True):
    """``decode_step`` as tensor-parallel products on this rank's shards,
    the contract of ``transformer.decode_step_sharded``: the token
    embedding and the learned position rows looked up as a vocab
    (``transformer.decode_embed``), the self-attention and MLP the dense
    family's over the self K / V cache's shard (its KV heads or its
    sequence), the cross-attention ``_cross_decode_tp`` over the cross
    cache's shard, the tied logits.  Returns (logits, the new local
    cache, the logits' spec)."""
    mesh, ps, cs = playout.mesh, playout.specs, clayout.specs
    b_ax = cs["k"][1]
    pos = P.local_slice(cache["len"], (b_ax,), mesh)
    n_pos = params["pos_embed"].shape[0] * P.mesh_axis_size(
        mesh, ps["pos_embed"][0])
    h = (T.decode_embed(cfg, params["embed"], ps["embed"][0],
                        batch["tokens"], mesh, b_ax)
         + T.decode_embed(cfg, params["pos_embed"], ps["pos_embed"][0],
                          torch.clamp(pos, 0, n_pos - 1)[:, None], mesh,
                          b_ax))
    lsp = tree_map(lambda sp: sp[1:], ps["dec_layers"])
    attn = T.decode_attn(cfg, mesh, lsp["self_attn"], cs["k"],
                         cache["k"].shape, pos)
    t_enc = cache["cross_k"].shape[2] * P.mesh_axis_size(mesh,
                                                         cs["cross_k"][2])
    new = {"k": [], "v": []}
    for i in range(cfg.n_layers):
        lp = T.layer_slice(params["dec_layers"], i)
        a, kc, vc, _, _ = attn(lp["self_attn"], T._norm(cfg, lp["ln1"], h),
                               cache["k"][i], cache["v"][i])
        h = h + a
        h = h + _cross_decode_tp(cfg, lp["cross_attn"], lsp["cross_attn"],
                                 T._norm(cfg, lp["ln_cross"], h),
                                 cache["cross_k"][i], cache["cross_v"][i],
                                 cs["cross_k"], t_enc, mesh)
        h = h + T._mlp_tp(cfg, lp["mlp"], lsp["mlp"],
                          T._norm(cfg, lp["ln2"], h), mesh, b_ax)
        T.keep_row(cache["k"], new["k"], i, kc, donate)
        T.keep_row(cache["v"], new["v"], i, vc, donate)
    out = {**cache, **T.stacked_rows(cache, new, donate),
           "len": cache["len"] + 1}
    logits, lspec = T.decode_logits(cfg, params, ps, h, mesh, b_ax)
    return logits, out, lspec
