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

The groups are the global batch's, as the reference's under ``jit``
whatever the sharding: where a rank holds part of the batch
(``Split``), a group that spans ranks counts its tokens' queue places
and its aux statistics across them (``moe_block``).  On a mesh the
experts split on ``model`` (expert parallelism: ``moe_tp``,
``forward_sharded``), and at decode their F dim on ``data`` too
(``decode_tp``, ``decode_step_sharded``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import partition as P

__all__ = ["init_params", "forward", "init_cache", "decode_step",
           "moe_block", "moe_tp", "decode_tp", "forward_sharded",
           "decode_step_sharded", "Split", "tp_widths"]


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


class Split(NamedTuple):
    """Where this rank's batch sits in the global batch: the global batch
    is split into equal consecutive parts over the mesh axes ``axes``
    (a spec entry, major first, as ``partition.batch_pspecs`` places the
    batch dim; ``None``: every rank holds the whole batch), and this
    rank holds the part at its coordinate along them."""

    mesh: object
    axes: object


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


def _route(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor):
    """x (T, D) -> (probs (T, E), top_p (T, k) renormalised, sel (T, k, E)
    the one-hot of each slot's expert); float32 at any model dtype."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    top_p, top_e = _top_k(probs, cfg.experts_per_token)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return probs, top_p, F.one_hot(top_e, cfg.n_experts).float()


def _expert_ffn(cfg: ModelConfig, p: dict, xe):
    """The experts' gated FFN on their dispatched tokens: xe (E, C, D) ->
    (E, C, D)."""
    cd = cfg.cdtype
    act = L.act_fn(cfg.activation)
    h = (act(torch.einsum("ecd,edf->ecf", xe, p["w_gate"].to(cd)))
         * torch.einsum("ecd,edf->ecf", xe, p["w_up"].to(cd)))
    return torch.einsum("ecf,efd->ecd", h, p["w_down"].to(cd))


def _experts(cfg: ModelConfig, p: dict, x, top_p, sel, cap: int,
             experts: tuple, offset=None, ffn=None):
    """The experts [lo, hi) = ``experts`` (``p``'s w_* hold just those) on
    the tokens x (T, D) that ``sel`` routes to them -> y (T, D), their
    share of the combined output.  ``offset`` (E,): the slots each
    expert's queue already holds from the group's tokens before these.
    ``ffn(xe)`` maps the dispatched tokens (E, C, D) to the experts'
    outputs (E, C, D') (``_expert_ffn`` unless given: the sharded decode
    step passes its products on a slice of each expert)."""
    t, k, e = sel.shape
    lo, hi = experts
    if (lo, hi) != (0, e):
        sel = sel[..., lo:hi]
        offset = None if offset is None else offset[lo:hi]
        e = hi - lo
    cd = cfg.cdtype
    # position of each (token, slot) within its expert's queue
    pos = torch.cumsum(sel.reshape(t * k, e), dim=0).reshape(t, k, e)
    if offset is not None:
        pos = pos + offset
    pos_in_e = (pos - 1.0) * sel
    keep = sel * (pos_in_e < cap)
    pos_oh = (F.one_hot(pos_in_e.long().clamp(0, cap - 1), cap).float()
              * keep[..., None])                               # (T,k,E,C)
    dispatch = pos_oh.sum(dim=1)                               # (T, E, C)
    combine = torch.einsum("tkec,tk->tec", pos_oh, top_p)

    xe = torch.einsum("tec,td->ecd", dispatch.to(cd), x.to(cd))
    ye = _expert_ffn(cfg, p, xe) if ffn is None else ffn(xe)
    y = torch.einsum("tec,ecd->td", combine.to(cd), ye)
    return y.to(x.dtype)


def _aux(cfg: ModelConfig, me, ce, experts: tuple):
    """The Switch load-balance term of a group, ``e * sum(me * ce) / k``
    over the experts [lo, hi) (all: the whole term)."""
    e, k = cfg.n_experts, cfg.experts_per_token
    lo, hi = experts
    if (lo, hi) != (0, e):
        me, ce = me[..., lo:hi], ce[..., lo:hi]
    return e * torch.sum(me * ce) / k


def _group_moe(cfg: ModelConfig, p: dict, x: torch.Tensor, experts: tuple,
               ffn=None):
    """One dispatch group whole on this rank: x (Tg, D) -> (y (Tg, D),
    aux loss)."""
    probs, top_p, sel = _route(cfg, p["router"], x)
    y = _experts(cfg, p, x, top_p, sel, capacity(cfg, x.shape[0]), experts,
                 ffn=ffn)
    # Switch-style load-balance aux loss: mean router prob times the
    # routed share
    return y, _aux(cfg, probs.mean(dim=0), sel.sum(dim=1).mean(dim=0),
                   experts)


def _spanning_groups(cfg: ModelConfig, p: dict, flat: torch.Tensor,
                     tg: int, split: Split, experts: tuple):
    """The reference's groups of ``tg`` consecutive tokens of the global
    (B·S) order, where they span the ranks of ``split``: this rank's
    tokens ``flat`` (T, D) are the global [r·T, (r + 1)·T), and the rank
    holding the global end zero-pads it to a whole group.  Each rank
    routes its pieces of the groups; one all-gather of the per-group,
    per-expert routed counts gives each token's place in its expert's
    queue (the counts of the ranks before it in the group, then its
    own), and a ``psum`` the routers' mean probabilities over each
    whole group.  -> (y (T, D), aux loss)."""
    mesh, axes = split
    n, e = flat.shape[0], cfg.n_experts
    parts, r = P.mesh_axis_size(mesh, axes), P.axis_index(mesh, axes)
    pad = (-n * parts) % tg
    n_groups = (n * parts + pad) // tg
    start = r * n
    if r == parts - 1:
        flat = F.pad(flat, (0, 0, 0, pad))
    end = start + flat.shape[0]
    pieces = [(g, max(start, g * tg) - start, min(end, (g + 1) * tg) - start)
              for g in range(start // tg, (end - 1) // tg + 1)]
    routed = [_route(cfg, p["router"], flat[lo:hi]) for _, lo, hi in pieces]
    counts = flat.new_zeros((n_groups, e), dtype=torch.float32)
    me_rows = [flat.new_zeros((e,), dtype=torch.float32)] * n_groups
    for (g, _, _), (probs, _, sel) in zip(pieces, routed):
        counts[g] = sel.sum(dim=(0, 1))
        me_rows[g] = probs.sum(dim=0)
    every = P.gather_along(counts[None], (axes, None, None), mesh,
                           P.axis_names(axes))         # (parts, G, E)
    before = every[:r].sum(dim=0)
    me = P.psum(torch.stack(me_rows), mesh, axes) / tg
    ce = every.sum(dim=0) / tg
    cap = capacity(cfg, tg)
    ys = [_experts(cfg, p, flat[lo:hi], top_p, sel, cap, experts, before[g])
          for (g, lo, hi), (_, top_p, sel) in zip(pieces, routed)]
    aux = _aux(cfg, me, ce, experts) / n_groups
    return torch.cat(ys)[:n], aux


def moe_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
              split: Split | None = None, experts: tuple | None = None,
              ffn=None):
    """x (B, S, D) -> (y, aux): the tokens in the reference's groups of
    ``tg = min(moe_group_size, B_global·S)`` consecutive tokens of the
    global batch (the last zero-padded), the aux loss averaged over the
    groups.  ``split`` says where this rank's batch sits in the global
    batch (``None``: it is the global batch):

      * where every rank's tokens are whole groups (``B·S % tg == 0``,
        e.g. the production ``train_4k`` cells, S = 4096 =
        ``moe_group_size``, or one rank) the groups run here, with no
        collective: the step's mean over the data-parallel ranks of each
        rank's mean aux is the mean over all groups;
      * else (a group longer than a rank's tokens, e.g. short
        sequences) a group spans ranks: ``_spanning_groups``, with the
        global queue positions and aux statistics.

    ``experts`` = [lo, hi) runs only those experts (``p``'s w_* hold just
    them: expert parallelism) and returns their share of y and of the
    aux loss; the routing is every expert's.  ``ffn``: the experts'
    products on the dispatched tokens (``_experts``), for groups whole
    on this rank."""
    b, s, d = x.shape
    n = b * s
    parts = 1 if split is None else P.mesh_axis_size(split.mesh, split.axes)
    tg = min(cfg.moe_group_size, n * parts)
    experts = experts or (0, cfg.n_experts)
    if n % tg:
        if parts > 1:
            y, aux = _spanning_groups(cfg, p, x.reshape(n, d), tg, split,
                                      experts)
            return y.reshape(b, s, d), aux
    flat = F.pad(x.reshape(n, d), (0, 0, 0, (-n) % tg))
    ys, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(flat.shape[0] // tg):
        y, a = _group_moe(cfg, p, flat[g * tg:(g + 1) * tg], experts, ffn)
        ys.append(y)
        aux = aux + a
    y = torch.cat(ys)[:n].reshape(b, s, -1)
    return y, aux / len(ys)


def moe_tp(cfg: ModelConfig, p: dict, x: torch.Tensor, mesh,
           split: Split | None = None):
    """The MoE block under tensor parallelism (expert parallelism on
    ``model``): ``x`` (B, S, D) already inside the region (``copy_to``),
    ``p`` this rank's experts ``[e_lo, e_hi)`` (``n_experts / model`` of
    them) and the replicated router, which enters the region through
    ``copy_to`` too.  Every rank routes every token to every expert (the
    same probabilities, top-k, dispatch and combine), runs its own
    experts, and their shares of y and of the aux loss are summed over
    ``model`` (``reduce_from``).  So the router's and x's gradients are
    partial on each rank, as a column-parallel product's, and each is
    summed over ``model`` once, by its ``copy_to``.

    No all-to-all: under TP the residual stream is replicated along
    ``model``, so each rank already holds every token its experts need.
    The reference's partitioner may move tokens instead; the function is
    the same.  Where ``p`` holds every expert (one rank on ``model``)
    this is ``moe_block``."""
    if p["w_gate"].shape[0] == cfg.n_experts:
        return moe_block(cfg, p, x, split)
    router = P.copy_to(p["router"], mesh)
    y, aux = moe_block(cfg, dict(p, router=router), x, split,
                       T._model_part(mesh, cfg.n_experts))
    return P.reduce_from(y, mesh), P.reduce_from(aux, mesh)


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


def forward(cfg: ModelConfig, params: dict, batch: dict,
            split: Split | None = None):
    """-> (logits (B, S, V), the aux loss averaged over the layers);
    ``split`` as ``moe_block``'s (the batch is this rank's part of a
    global batch: the gathered sharded step)."""
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
        y, a = moe_block(cfg, lp["moe"], T._norm(cfg, lp["ln2"], h),
                         split)
        return h + y, aux + a

    body = T.remat_wrap(cfg, body)
    for lp in T.layer_list(params["layers"], cfg.n_layers):
        h, aux = body(h, aux, lp)
    return T.logits_from_hidden(cfg, params, h), aux / cfg.n_layers


init_cache = T.init_cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict,
                donate: bool = False):
    """One decode step: tokens (B, 1) -> logits (B, 1, V), new cache
    (``donate`` as ``transformer.decode_step``)."""
    tokens = batch["tokens"].to(params["embed"].device)
    h = T.embed_tokens(cfg, params, tokens)

    def attn(p, hn, kc, vc, ks, vs):
        return T.attn_decode_apply(cfg, p, hn, kc, vc, cache["len"], ks, vs,
                                   donate=donate)

    def mlp(lp, hn):
        return moe_block(cfg, lp["moe"], hn)[0]

    h, new = T._layer_loop(cfg, params, cache, h, attn, mlp)
    new["len"] = cache["len"] + 1
    return T.logits_from_hidden(cfg, params, h), new


def tp_widths(cfg: ModelConfig) -> tuple:
    """The dense widths with the experts in place of the ffn width
    (expert parallelism on ``model``)."""
    return (cfg.padded_vocab, cfg.n_experts, cfg.n_heads * cfg.hd,
            cfg.n_kv_heads * cfg.hd)


def forward_sharded(cfg: ModelConfig, params: dict, batch: dict, layout,
                    split: Split | None = None):
    """``forward`` on this rank's shards -> (this rank's logits (B_local,
    S, V / model), the aux loss averaged over the layers): attention,
    embedding and logits are ``transformer.forward_sharded``'s (ZeRO-3 on
    ``data`` inside the checkpointed layer body, TP on ``model``), the
    MoE block ``moe_tp`` on the rank's ``n_experts / model`` experts,
    gathered along ``data``.  Needs ``factory.shards``; on one
    rank it is ``forward``, bit for bit."""
    mesh = layout.mesh

    def ffn(lp, x):
        return moe_tp(cfg, lp["moe"], x, mesh, split)

    logits, aux = T._forward_sharded(cfg, params, batch, layout, ffn)
    return logits, aux / cfg.n_layers


def decode_tp(cfg: ModelConfig, p: dict, sp: dict, hn, mesh, b_ax):
    """The MoE block of one decode token on this rank's expert shards at
    the serving layout (``serve_param_pspecs``: experts on ``model``, the
    expert F dim on ``data``; at ``global_batch == 1`` the w_gate / w_up
    D dim and w_down's output on ``data``), ``sp`` their specs.  The
    rows are all-gathered along the batch axes ``b_ax``, so the whole
    decode group (the global batch) is on every rank and its dispatch,
    capacity and drops are the reference's with no count exchanged
    (``moe_block`` without a ``Split``).  Each rank runs its experts'
    slice on every token: where D is split the gate / up partials are
    summed over its axes (one all-reduce) before the activation.  y is
    summed over the axes of the experts and F and left as the local
    batch's rows (``partition.sum_to_shard``), its D columns gathered
    where w_down splits them.  ``moe_block`` on the local rows on one
    rank."""
    (e_ax, d_ax, f_ax), o_ax = sp["w_gate"], sp["w_down"][-1]
    if not any(P.sharded_axes(s, mesh) for s in (sp["w_gate"],
                                                sp["w_down"], (b_ax,))):
        return moe_block(cfg, p, hn)[0]
    experts = (T._model_part(mesh, cfg.n_experts)
               if P.axis_names(e_ax) == ("model",) else None)
    cd = cfg.cdtype
    act = L.act_fn(cfg.activation)

    def ffn(xe):
        xe = P.local_slice(xe, (None, None, d_ax), mesh)
        gu = torch.stack([torch.einsum("ecd,edf->ecf", xe, p[n].to(cd))
                          for n in ("w_gate", "w_up")])
        g, u = P.all_reduce(gu, mesh, d_ax).unbind(0)
        return torch.einsum("ecf,efd->ecd", act(g) * u, p["w_down"].to(cd))

    y = moe_block(cfg, p, T.gather_rows(hn, mesh, b_ax), None, experts,
                  ffn)[0]
    y = P.sum_to_shard(y, mesh, P.axis_names(e_ax) + P.axis_names(f_ax), 0,
                       b_ax)
    return P.gather_along(y, (None, None, o_ax), mesh, P.axis_names(o_ax))


def decode_step_sharded(cfg: ModelConfig, params: dict, cache: dict,
                        batch: dict, playout, clayout, donate: bool = True):
    """``decode_step`` on this rank's shards (``transformer.
    decode_step_sharded``'s embedding, attention, cache and logits), the
    MoE block ``decode_tp`` on the rank's experts' slices over the whole
    decode group."""
    mesh, b_ax = playout.mesh, clayout.specs["k"][1]

    def ffn(lp, sp, hn):
        return decode_tp(cfg, lp["moe"], sp["moe"], hn, mesh, b_ax)

    return T.decode_step_sharded(cfg, params, cache, batch, playout,
                                 clayout, donate, ffn)
