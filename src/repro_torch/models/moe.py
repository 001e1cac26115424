"""Mixture-of-Experts decoder LMs — dbrx-132b (16 experts, top-4),
phi3.5-moe (16 experts, top-2) — mirroring ``src/repro/models/moe.py``.

Dispatch is group-wise with static capacity: tokens run in groups of
``moe_group_size``; within a group a one-hot dispatch / combine pair
routes at most ``capacity`` tokens to each expert, in token order, and
the overflow drops — the reference's drop pattern exactly (capacity
``max(4, (int(tg·k/e·cf) + 3) & ~3)``; top-k ties go to the lower expert
index, as ``jax.lax.top_k``'s).  The router runs in float32 at any model
dtype; the expert products are plain batched products (``torch.einsum``),
as the reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

__all__ = ["init_params", "forward", "init_cache", "decode_step",
           "moe_block"]


def init_moe_layer(cfg: ModelConfig, gen, lead: tuple, device) -> dict:
    """Router N(0, 1/d) in float32; expert weights (E, d_in, d_out)
    N(0, 1/d_in) at the model dtype."""
    d, f, e, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.dtype
    return {"router": T.normal(gen, lead + (d, e), d ** -0.5, torch.float32,
                               device),
            "w_gate": T.normal(gen, lead + (e, d, f), d ** -0.5, dt, device),
            "w_up": T.normal(gen, lead + (e, d, f), d ** -0.5, dt, device),
            "w_down": T.normal(gen, lead + (e, f, d), f ** -0.5, dt,
                               device)}


def _top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index (a
    stable descending sort), as ``jax.lax.top_k``."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg: ModelConfig, tg: int) -> int:
    """Slots an expert takes in a group of ``tg`` tokens (the reference's
    expression: ``+`` binds tighter than ``&``)."""
    e, k = cfg.n_experts, cfg.experts_per_token
    return max(4, (int(tg * k / e * cfg.capacity_factor) + 3) & ~3)


def _group_moe(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """One dispatch group: x (Tg, D) -> (y (Tg, D), aux loss)."""
    tg = x.shape[0]
    e, k = cfg.n_experts, cfg.experts_per_token
    cd = cfg.cdtype
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    top_p, top_e = _top_k(probs, k)                            # (Tg, k)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    cap = capacity(cfg, tg)
    sel = F.one_hot(top_e, e).float()                          # (Tg, k, E)
    # position of each (token, slot) within its expert's queue
    pos_in_e = (torch.cumsum(sel.reshape(tg * k, e), dim=0)
                .reshape(tg, k, e) - 1.0) * sel
    keep = sel * (pos_in_e < cap)
    pos_oh = (F.one_hot(pos_in_e.long().clamp(0, cap - 1), cap).float()
              * keep[..., None])                               # (Tg,k,E,C)
    dispatch = pos_oh.sum(dim=1)                               # (Tg, E, C)
    combine = torch.einsum("tkec,tk->tec", pos_oh, top_p)

    xe = torch.einsum("tec,td->ecd", dispatch.to(cd), x.to(cd))
    act = L.act_fn(cfg.activation)
    h = (act(torch.einsum("ecd,edf->ecf", xe, p["w_gate"].to(cd)))
         * torch.einsum("ecd,edf->ecf", xe, p["w_up"].to(cd)))
    ye = torch.einsum("ecf,efd->ecd", h, p["w_down"].to(cd))
    y = torch.einsum("tec,ecd->td", combine.to(cd), ye)

    # Switch-style load-balance aux loss
    me = probs.mean(dim=0)                                     # (E,)
    ce = sel.sum(dim=1).mean(dim=0)                            # routed share
    aux = e * torch.sum(me * ce) / k
    return y.to(x.dtype), aux


def moe_block(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x (B, S, D) -> (y, aux): tokens in groups of ``moe_group_size``
    (the last zero-padded), the aux loss averaged over the groups."""
    b, s, d = x.shape
    t = b * s
    tg = min(cfg.moe_group_size, t)
    flat = F.pad(x.reshape(t, d), (0, 0, 0, (-t) % tg))
    ys, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(flat.shape[0] // tg):
        y, a = _group_moe(cfg, p, flat[g * tg:(g + 1) * tg])
        ys.append(y)
        aux = aux + a
    y = torch.cat(ys)[:t].reshape(b, s, d)
    return y, aux / len(ys)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> dict:
    dev = resolve_device(device)
    gen = T._generator(generator, dev)
    n = (cfg.n_layers,)
    params = T.init_embed(cfg, gen, dev)
    params["layers"] = {"ln1": T.init_norm(cfg, n, dev),
                        "attn": T.init_attn_layer(cfg, gen, n, dev),
                        "ln2": T.init_norm(cfg, n, dev),
                        "moe": init_moe_layer(cfg, gen, n, dev)}
    return params


def forward(cfg: ModelConfig, params: dict, batch: dict):
    """-> (logits (B, S, V), the aux loss averaged over the layers)."""
    tokens = batch["tokens"].to(params["embed"].device)
    b, s = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    h = T.embed_tokens(cfg, params, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    def body(h, aux, lp):
        h = h + T.attn_apply(cfg, lp["attn"], T._norm(cfg, lp["ln1"], h),
                             positions)
        y, a = moe_block(cfg, lp["moe"], T._norm(cfg, lp["ln2"], h))
        return h + y, aux + a

    body = T.remat_wrap(cfg, body)
    for lp in T.layer_list(params["layers"], cfg.n_layers):
        h, aux = body(h, aux, lp)
    return T.logits_from_hidden(cfg, params, h), aux / cfg.n_layers


init_cache = T.init_cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    """One decode step: tokens (B, 1) -> logits (B, 1, V), new cache."""
    tokens = batch["tokens"].to(params["embed"].device)
    h = T.embed_tokens(cfg, params, tokens)

    def attn(p, hn, kc, vc, ks, vs):
        return T.attn_decode_apply(cfg, p, hn, kc, vc, cache["len"], ks, vs)

    def mlp(lp, hn):
        return moe_block(cfg, lp["moe"], hn)[0]

    h, new = T._layer_loop(cfg, params, cache, h, attn, mlp)
    new["len"] = cache["len"] + 1
    return T.logits_from_hidden(cfg, params, h), new
