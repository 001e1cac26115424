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
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

__all__ = ["init_params", "forward", "encode", "init_cache", "prime_cross",
           "decode_step"]

MAX_POS = 32768                 # rows of the learned decoder positions


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
