"""RWKV6 ("Finch") — the attention-free LM with data-dependent decay
(mirrors ``src/repro/models/rwkv.py``).

Token-shift lerp mixes for (r, k, v, w, g), the LoRA-style decay
``w = exp(-exp(w0 + tanh(x @ A) @ B))``, a per-head bonus ``u``, a
per-head RMS norm and a squared-ReLU channel mix.  The WKV recurrence
runs sequentially over time in float32 (forward and chunked prefill) and
as an O(1) state update at decode; ``w0`` and ``u`` stay float32 at any
model dtype.

State per head: a (K, V) outer-product accumulator;
  y_t = r_t . (state + (u * k_t) v_t^T);  state' = diag(w_t) state + k_t v_t^T
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

__all__ = ["init_params", "forward", "init_cache", "decode_step",
           "prefill_chunk", "time_mix_apply", "channel_mix_apply"]

LORA_W = 64                     # decay LoRA rank


def _heads(cfg: ModelConfig):
    hd = cfg.rwkv_head_dim
    return cfg.d_model // hd, hd


def init_time_mix(cfg: ModelConfig, gen, lead: tuple, dev) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    h, hd = _heads(cfg)

    def proj(d_in, d_out, scale=None):
        return T.normal(gen, lead + (d_in, d_out),
                        d_in ** -0.5 if scale is None else scale, dt, dev)

    return {"mix": torch.full(lead + (5, d), 0.5, dtype=dt, device=dev),
            "w0": torch.full(lead + (d,), -2.0, dtype=torch.float32,
                             device=dev),
            "w_a": proj(d, LORA_W, 0.01), "w_b": proj(LORA_W, d, 0.01),
            "u": T.normal(gen, lead + (h, hd), 0.1, torch.float32, dev),
            "wr": proj(d, d), "wk": proj(d, d), "wv": proj(d, d),
            "wg": proj(d, d), "wo": proj(d, d),
            "ln_x": torch.ones(lead + (d,), dtype=dt, device=dev)}


def init_channel_mix(cfg: ModelConfig, gen, lead: tuple, dev) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    return {"mix": torch.full(lead + (2, d), 0.5, dtype=dt, device=dev),
            "wk": T.normal(gen, lead + (d, f), d ** -0.5, dt, dev),
            "wv": T.normal(gen, lead + (f, d), f ** -0.5, dt, dev),
            "wr": T.normal(gen, lead + (d, d), d ** -0.5, dt, dev)}


def _shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1}, with ``last`` (B, D) at position 0."""
    return torch.cat([last[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _head_norm(y: torch.Tensor, w: torch.Tensor, h: int, hd: int,
               eps: float) -> torch.Tensor:
    """Per-head RMS norm (the group-norm analogue).  y: (B, S, H, hd)."""
    yf = y.float()
    yf = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + eps)
    b, s = y.shape[:2]
    return (yf.reshape(b, s, h * hd) * w.float()).to(y.dtype)


def time_mix_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, last_x,
                   state, valid=None):
    """x (B, S, D); last_x (B, D); state (B, H, K, V) float32 -> (out,
    new last_x, new state).  ``valid`` (B, S) marks real tokens (chunked
    prefill pads a partial final chunk): an invalid position forces
    k -> 0 and w -> 1, so the state passes through it unchanged."""
    b, s, d = x.shape
    h, hd = _heads(cfg)
    xs = _shift(x, last_x)
    mix = p["mix"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + mix[i] * (xs - x) for i in range(5))
    r = L.dense(xr, p["wr"]).reshape(b, s, h, hd)
    k = L.dense(xk, p["wk"]).reshape(b, s, h, hd)
    v = L.dense(xv, p["wv"]).reshape(b, s, h, hd)
    g = L.dense(xg, p["wg"])
    w = torch.exp(-torch.exp(
        p["w0"].float()
        + L.dense(torch.tanh(L.dense(xw, p["w_a"])), p["w_b"]).float()
    )).reshape(b, s, h, hd)                    # (0, 1) decay per channel
    if valid is not None:
        m = valid[:, :, None, None]
        k = torch.where(m, k, torch.zeros_like(k))
        w = torch.where(m, w, torch.ones_like(w))
    u = p["u"].float()[None, :, :, None]
    st = state.float()
    ys = []
    for t in range(s):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t].float(), v[:, t].float())
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t].float(),
                               st + u * kv))
        st = w[:, t].float()[..., None] * st + kv
    y = torch.stack(ys, dim=1)                 # (B, S, H, hd)
    y = _head_norm(y, p["ln_x"], h, hd, cfg.norm_eps).to(x.dtype)
    y = y * F.silu(g)
    return L.dense(y, p["wo"]).to(x.dtype), x[:, -1, :], st


def channel_mix_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, last_x):
    xs = _shift(x, last_x)
    mix = p["mix"].to(x.dtype)
    xk = x + mix[0] * (xs - x)
    xr = x + mix[1] * (xs - x)
    k = torch.square(torch.relu(L.dense(xk, p["wk"])))
    out = torch.sigmoid(L.dense(xr, p["wr"])) * L.dense(k, p["wv"])
    return out.to(x.dtype), x[:, -1, :]


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> dict:
    dev = resolve_device(device)
    gen = T._generator(generator, dev)
    n = (cfg.n_layers,)
    params = T.init_embed(cfg, gen, dev)
    params["layers"] = {"ln1": T.init_norm(cfg, n, dev),
                        "tm": init_time_mix(cfg, gen, n, dev),
                        "ln2": T.init_norm(cfg, n, dev),
                        "cm": init_channel_mix(cfg, gen, n, dev)}
    return params


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device=None) -> dict:
    """The recurrent states, zero: token-shift ``tm_x`` / ``cm_x``
    (L, B, D) in the compute dtype, ``wkv`` (L, B, H, hd, hd) float32."""
    dev = resolve_device(device)
    h, hd = _heads(cfg)
    n, b, d = cfg.n_layers, batch_size, cfg.d_model
    return {"tm_x": torch.zeros((n, b, d), dtype=cfg.cdtype, device=dev),
            "cm_x": torch.zeros((n, b, d), dtype=cfg.cdtype, device=dev),
            "wkv": torch.zeros((n, b, h, hd, hd), dtype=torch.float32,
                               device=dev),
            "len": torch.zeros((b,), dtype=torch.int32, device=dev)}


def _run(cfg: ModelConfig, params: dict, cache: dict, tokens, valid=None,
         last_idx=None):
    """The layer loop from the cached states -> (h, new states).  The
    token-shift states advance to the last token, or with ``last_idx``
    (B,) to that position (the last valid one of a padded chunk)."""
    h = T.embed_tokens(cfg, params, tokens)
    new = {"tm_x": [], "cm_x": [], "wkv": []}

    def last(xn):
        if last_idx is None:
            return xn[:, -1]
        idx = last_idx[:, None, None].expand(-1, 1, xn.shape[-1]).long()
        return torch.take_along_dim(xn, idx, dim=1)[:, 0]

    for i in range(cfg.n_layers):
        lp = T.layer_slice(params["layers"], i)
        xn1 = T._norm(cfg, lp["ln1"], h)
        a, _, wkv = time_mix_apply(cfg, lp["tm"], xn1, cache["tm_x"][i],
                                   cache["wkv"][i], valid=valid)
        h = h + a
        xn2 = T._norm(cfg, lp["ln2"], h)
        c, _ = channel_mix_apply(cfg, lp["cm"], xn2, cache["cm_x"][i])
        h = h + c
        new["tm_x"].append(last(xn1))
        new["cm_x"].append(last(xn2))
        new["wkv"].append(wkv)
    return h, {n: torch.stack(ts) for n, ts in new.items()}


def forward(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V), every layer from zero states."""
    tokens = batch["tokens"].to(params["embed"].device)
    st = init_cache(cfg, tokens.shape[0], 0, tokens.device)
    h = T.embed_tokens(cfg, params, tokens)

    def body(h, lp, tm_x, cm_x, wkv):
        a, _, _ = time_mix_apply(cfg, lp["tm"], T._norm(cfg, lp["ln1"], h),
                                 tm_x, wkv)
        h = h + a
        c, _ = channel_mix_apply(cfg, lp["cm"], T._norm(cfg, lp["ln2"], h),
                                 cm_x)
        return h + c

    body = T.remat_wrap(cfg, body)
    for i, lp in enumerate(T.layer_list(params["layers"], cfg.n_layers)):
        h = body(h, lp, st["tm_x"][i], st["cm_x"][i], st["wkv"][i])
    return T.logits_from_hidden(cfg, params, h)


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    tokens = batch["tokens"].to(params["embed"].device)
    h, new = _run(cfg, params, cache, tokens)
    new["len"] = cache["len"] + 1
    return T.logits_from_hidden(cfg, params, h), new


def prefill_chunk(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    """Chunked prefill from the cached (tm_x, cm_x, wkv) states, the
    contract of ``transformer.prefill_chunk``: the token-shift states
    advance to the last valid token of the chunk, and pad positions leave
    the WKV accumulator untouched."""
    tokens = batch["tokens"].to(params["embed"].device)
    c = tokens.shape[1]
    start = cache["len"]
    n_valid = batch.get("n_valid")
    if n_valid is None:
        n_valid = torch.full_like(start, c)
    n_valid = n_valid.to(start.device)
    valid = (torch.arange(c, dtype=torch.int32, device=start.device)[None]
             < n_valid[:, None])
    h, new = _run(cfg, params, cache, tokens, valid=valid,
                  last_idx=torch.clamp_min(n_valid - 1, 0))
    new["len"] = start + n_valid
    return T.logits_from_hidden(cfg, params, h), new
