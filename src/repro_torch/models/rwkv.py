"""RWKV6 ("Finch") — the attention-free LM with data-dependent decay
(mirrors ``src/repro/models/rwkv.py``).

Token-shift lerp mixes for (r, k, v, w, g), the LoRA-style decay
``w = exp(-exp(w0 + tanh(x @ A) @ B))``, a per-head bonus ``u``, a
per-head RMS norm and a squared-ReLU channel mix.  The WKV recurrence
runs in float32 as one op (``kernels/wkv.wkv6``: on the card one CUDA
kernel a layer for a whole forward, prefill chunk or decode step, and
one for its backward; in a dry run one node with a Meta implementation;
on the CPU the plain per-token loop ``kernels/ref.wkv6_ref``); ``w0``
and ``u`` stay float32 at any model dtype.

State per head: a (K, V) outer-product accumulator;
  y_t = r_t . (state + (u * k_t) v_t^T);  state' = diag(w_t) state + k_t v_t^T

On a mesh (``forward_sharded``, ``decode_step_sharded``) the time mix's
r / k / v / g / decay products are column-parallel on ``model`` and its
output row-parallel; in training the WKV runs on a rank's heads, at
decode on the cache's own K slice of every head, the partial ``y``
summed over ``model``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import wkv as WKV
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import partition as P
from repro_torch.tree import tree_map

__all__ = ["init_params", "forward", "init_cache", "decode_step",
           "prefill_chunk", "time_mix_apply", "channel_mix_apply",
           "forward_sharded", "decode_step_sharded", "tp_widths"]

LORA_W = 64                     # decay LoRA rank


def tp_widths(cfg: ModelConfig) -> tuple:
    """The dims the sharded steps split on ``model``: the padded vocab,
    the channel mix's width, the time mix's (d_model) and its decay
    LoRA's rank."""
    return (cfg.padded_vocab, cfg.d_ff, cfg.d_model, LORA_W)


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
    xr, xk, xv, xw, xg = _mixes(p, x, last_x, 5)
    r = L.dense(xr, p["wr"]).reshape(b, s, h, hd)
    k = L.dense(xk, p["wk"]).reshape(b, s, h, hd)
    v = L.dense(xv, p["wv"]).reshape(b, s, h, hd)
    g = L.dense(xg, p["wg"])
    w = _decay(p["w0"], L.dense(torch.tanh(L.dense(xw, p["w_a"])), p["w_b"])
               ).reshape(b, s, h, hd)          # (0, 1) decay per channel
    if valid is not None:
        m = valid[:, :, None, None]
        k = torch.where(m, k, torch.zeros_like(k))
        w = torch.where(m, w, torch.ones_like(w))
    y, st = _wkv(r, k, v, w, p["u"], state)
    y = _head_norm(y, p["ln_x"], h, hd, cfg.norm_eps).to(x.dtype)
    y = y * F.silu(g)
    return L.dense(y, p["wo"]).to(x.dtype), x[:, -1, :], st


def _mixes(p: dict, x, last_x, n: int) -> tuple:
    """The ``n`` token-shift lerps of x (B, S, D) with ``p["mix"]``."""
    xs = _shift(x, last_x)
    mix = p["mix"].to(x.dtype)
    return tuple(x + mix[i] * (xs - x) for i in range(n))


def _decay(w0, lora) -> torch.Tensor:
    """The data-dependent decay exp(-exp(w0 + lora)), float32."""
    return torch.exp(-torch.exp(w0.float() + lora.float()))


def _wkv(r, k, v, w, u, state):
    """The WKV recurrence in float32: r / k / w (B, S, H, K), v (B, S, H,
    V), u (H, K), state (B, H, K, V) -> (y (B, S, H, V), the new state),
    through ``WKV.wkv6``, which places the call (the kernels on CUDA and
    a dry run's fake tensors, the plain per-token loop on the CPU and
    under the ``ESPIM_IMPL=ref`` pin).  ``y`` sums over K, so a K slice
    of every head gives a partial ``y``."""
    return WKV.wkv6(r, k, v, w, u, state)


def channel_mix_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, last_x):
    xk, xr = _mixes(p, x, last_x, 2)
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


# --------------------------------------------------------------------------
# rwkv6 on a mesh: each rank's shards, explicit collectives
# --------------------------------------------------------------------------
def _time_mix_tp(cfg: ModelConfig, p: dict, x, last_x, state, mesh):
    """The time mix under tensor parallelism, in training: ``x`` (B, S, D)
    inside the region (``copy_to``), ``p`` a layer's params gathered
    along ``data`` (wr / wk / wv / wg / w_a / w_b their output columns on
    ``model``, wo its rows; mix, w0, u and ln_x replicated, entering the
    region).  The WKV runs on this rank's heads (``d_model / hd / model``
    of them where that divides, else every head: r / k / v / g / w
    gathered along ``model`` as ``transformer._columns`` does); the decay
    LoRA's rank-64 hidden ``tanh(x @ w_a)`` is gathered along ``model``
    before ``w_b``.  Returns this rank's partial of wo summed over
    ``model``; ``time_mix_apply``'s on one rank."""
    tp = P.mesh_axis_size(mesh, "model")
    if tp == 1:
        return time_mix_apply(cfg, p, x, last_x, state)[0]
    b, s, d = x.shape
    h, hd = _heads(cfg)
    cols = T._model_part(mesh, d)
    lo, hi = (0, h) if h % tp else T._model_part(mesh, h)
    want = (lo * hd, hi * hd)
    rep = {k: P.copy_to(p[k], mesh) for k in ("mix", "w0", "u", "ln_x")}
    xr, xk, xv, xw, xg = _mixes(rep, x, last_x, 5)

    def heads(y):
        return T._columns(y, cols, want, d, mesh).reshape(b, s, hi - lo, hd)

    r = heads(L.dense(xr, p["wr"]))
    k = heads(L.dense(xk, p["wk"]))
    v = heads(L.dense(xv, p["wv"]))
    g = T._columns(L.dense(xg, p["wg"]), cols, want, d, mesh)
    lora = P.gather_dim(torch.tanh(L.dense(xw, p["w_a"])), 2, mesh, "model")
    w = heads(_decay(rep["w0"][cols[0]:cols[1]], L.dense(lora, p["w_b"])))
    y, _ = _wkv(r, k, v, w, rep["u"][lo:hi], state[:, lo:hi])
    y = _head_norm(y, rep["ln_x"][want[0]:want[1]], hi - lo, hd,
                   cfg.norm_eps).to(x.dtype)
    y = T._columns(y * F.silu(g), want, cols, d, mesh)
    return P.reduce_from(L.dense(y, p["wo"]), mesh).to(x.dtype)


def _channel_mix_tp(cfg: ModelConfig, p: dict, x, last_x, mesh):
    """The channel mix under tensor parallelism, in training: ``wk`` /
    ``wr`` column-parallel and ``wv`` row-parallel on ``model``; the
    rank's ``sigmoid(x @ wr)`` columns are gathered into the whole row
    that multiplies the ``wv`` product summed over ``model``
    (``gather_whole``: both are the same on every rank)."""
    if P.mesh_axis_size(mesh, "model") == 1:
        return channel_mix_apply(cfg, p, x, last_x)[0]
    xk, xr = _mixes({"mix": P.copy_to(p["mix"], mesh)}, x, last_x, 2)
    k = torch.square(torch.relu(L.dense(xk, p["wk"])))
    kv = P.reduce_from(L.dense(k, p["wv"]), mesh)
    r = P.gather_whole(torch.sigmoid(L.dense(xr, p["wr"])), 2, mesh)
    return (r * kv).to(x.dtype)


def forward_sharded(cfg: ModelConfig, params: dict, batch: dict,
                    layout) -> torch.Tensor:
    """``forward`` on this rank's shards (``params`` placed by ``layout``:
    ``param_pspecs``, FSDP on ``data`` inside each layer's remat unit,
    TP on ``model``; ``batch`` this rank's part): ``_time_mix_tp`` and
    ``_channel_mix_tp`` from zero states, a vocab-parallel embedding and
    the tied logits left split on ``model``.  Returns this rank's logits
    (B_local, S, V / model); on one rank ``forward``, bit for bit."""
    mesh, specs = layout.mesh, layout.specs
    tokens = batch["tokens"].to(params["embed"].device)
    st = init_cache(cfg, tokens.shape[0], 0, tokens.device)
    embed = P.fsdp_gather(params["embed"], specs["embed"], mesh)
    h = T._embed_tp(cfg, embed, tokens, mesh)
    lsp = tree_map(lambda sp: sp[1:], specs["layers"])

    def body(h, lp, tm_x, cm_x, wkv):
        lp = T.fsdp_tree(lp, lsp, mesh)
        x = P.copy_to(T._norm(cfg, lp["ln1"], h), mesh)
        h = h + _time_mix_tp(cfg, lp["tm"], x, tm_x, wkv, mesh)
        x = P.copy_to(T._norm(cfg, lp["ln2"], h), mesh)
        return h + _channel_mix_tp(cfg, lp["cm"], x, cm_x, mesh)

    body = T.remat_wrap(cfg, body)
    for i, lp in enumerate(T.layer_list(params["layers"], cfg.n_layers)):
        h = body(h, lp, st["tm_x"][i], st["cm_x"][i], st["wkv"][i])
    top = {"embed": embed,
           "final_norm": T.fsdp_tree(params["final_norm"],
                                     specs["final_norm"], mesh)}
    return T.logits_from_hidden(cfg, top, h, mesh)


def _time_mix_decode_tp(cfg: ModelConfig, p: dict, sp: dict, x, last_x,
                        state, w_spec, mesh):
    """One token's time mix on this rank's weight shards and its shard of
    the WKV state (``w_spec``: batch, heads, K, V; ``cache_pspecs`` puts
    K on ``model``).  The state update ``diag(w) S + k v^T`` is local on
    the rank's K slice of every head, so r / k / w (their columns, whole
    heads, gathered along ``model``: B x d_model) are sliced to that K
    slice and v taken whole; ``y = r . (S + u k v^T)`` sums over K, so
    the partial ``y`` is all-reduced over K's axes.  The head norm runs
    on every head, then ``y * silu(g)`` on g's columns and wo's rows,
    summed over them.  The decay LoRA's hidden is gathered before
    ``w_b``.  No param leaf moves.  Returns (out (B, 1, D), the new
    state shard)."""
    b = x.shape[0]
    h, hd = _heads(cfg)
    xr, xk, xv, xw, xg = _mixes(p, x, last_x, 5)
    yr, yk, yv, yg, ya = T.proj_tp(p, sp, ((xr, "wr"), (xk, "wk"),
                                           (xv, "wv"), (xg, "wg"),
                                           (xw, "w_a")), mesh)

    def whole(y, name):
        c = sp[name][-1]
        return P.gather_along(y, (None, None, c), mesh, P.axis_names(c))

    (yb,) = T.proj_tp(p, sp, ((whole(torch.tanh(ya), "w_a"), "w_b"),), mesh)
    w = _decay(p["w0"], whole(yb, "w_b"))
    _, h_ax, k_ax, _ = w_spec

    def part(y, spec):
        return P.local_slice(y.reshape(b, h, hd), spec, mesh)[:, None]

    hk = (None, h_ax, k_ax)
    y, state = _wkv(part(whole(yr, "wr"), hk), part(whole(yk, "wk"), hk),
                    part(whole(yv, "wv"), (None, h_ax, None)),
                    part(w, hk), P.local_slice(p["u"], hk[1:], mesh), state)
    y = P.gather_along(P.all_reduce(y, mesh, k_ax), (None, None, h_ax, None),
                       mesh, P.axis_names(h_ax))
    y = _head_norm(y, p["ln_x"], h, hd, cfg.norm_eps).to(x.dtype)
    g_ax, (o_in, o_out) = sp["wg"][-1], sp["wo"]
    y = P.local_slice(y, (None, None, g_ax), mesh) * F.silu(yg)
    if o_in != g_ax:
        y = P.local_slice(P.gather_along(y, (None, None, g_ax), mesh,
                                         P.axis_names(g_ax)),
                          (None, None, o_in), mesh)
    out = P.all_reduce(L.dense(y, p["wo"]), mesh, o_in)
    out = P.gather_along(out, (None, None, o_out), mesh, P.axis_names(o_out))
    return out.to(x.dtype), state


def _channel_mix_decode_tp(cfg: ModelConfig, p: dict, sp: dict, x, last_x,
                           mesh, b_ax):
    """One token's channel mix at the serving layout (``wk`` / ``wr``
    columns and ``wv`` rows on (``data``, ``model``)), as the dense
    family's ``_mlp_tp``: the rows gathered along the batch axes among
    those, the partial ``wv`` products summed and left as the local
    rows; ``sigmoid(x @ wr)``'s columns gathered and narrowed to the
    local rows, so both factors hold the same rows and columns.
    ``channel_mix_apply`` where nothing is split."""
    f_ax, r_ax = sp["wk"][-1], sp["wr"][-1]
    if not P.sharded_axes((f_ax, r_ax), mesh):
        return channel_mix_apply(cfg, p, x, last_x)[0]
    xk, xr = _mixes(p, x, last_x, 2)
    take = T._row_axes(b_ax, f_ax)
    k = torch.square(torch.relu(L.dense(T.gather_rows(xk, mesh, b_ax, take),
                                        p["wk"])))
    kv = P.sum_to_shard(L.dense(k, p["wv"]), mesh, f_ax, 0, take)
    r = torch.sigmoid(L.dense(T.gather_rows(xr, mesh, b_ax, take), p["wr"]))
    r = P.gather_along(r, (None, None, r_ax), mesh, P.axis_names(r_ax))
    rows = take[0] if len(take) == 1 else (take or None)
    r = P.local_slice(r, (rows, None, None), mesh)
    return (r * kv).to(x.dtype)


def decode_step_sharded(cfg: ModelConfig, params: dict, cache: dict,
                        batch: dict, playout, clayout, donate: bool = True):
    """``decode_step`` as tensor-parallel products on this rank's shards,
    the contract of ``transformer.decode_step_sharded`` (params at
    ``serve_param_pspecs``; the cache at ``cache_pspecs``: the
    token-shift states by batch, the WKV state by batch and K): the
    dense family's embedding and logits, ``_time_mix_decode_tp`` and
    ``_channel_mix_decode_tp``.  Returns (logits, the new local cache,
    the logits' spec)."""
    mesh, ps, cs = playout.mesh, playout.specs, clayout.specs
    b_ax = cs["wkv"][1]
    h = T.decode_embed(cfg, params["embed"], ps["embed"][0], batch["tokens"],
                       mesh, b_ax)
    lsp = tree_map(lambda sp: sp[1:], ps["layers"])
    new = {"tm_x": [], "cm_x": [], "wkv": []}
    for i in range(cfg.n_layers):
        lp = T.layer_slice(params["layers"], i)
        xn1 = T._norm(cfg, lp["ln1"], h)
        a, wkv = _time_mix_decode_tp(cfg, lp["tm"], lsp["tm"], xn1,
                                     cache["tm_x"][i], cache["wkv"][i],
                                     cs["wkv"][1:], mesh)
        h = h + a
        xn2 = T._norm(cfg, lp["ln2"], h)
        h = h + _channel_mix_decode_tp(cfg, lp["cm"], lsp["cm"], xn2,
                                       cache["cm_x"][i], mesh, b_ax)
        for n, t in (("tm_x", xn1[:, -1]), ("cm_x", xn2[:, -1]),
                     ("wkv", wkv)):
            T.keep_row(cache[n], new[n], i, t, donate)
    out = T.stacked_rows(cache, new, donate)
    out["len"] = cache["len"] + 1
    logits, lspec = T.decode_logits(cfg, params, ps, h, mesh, b_ax)
    return logits, out, lspec
