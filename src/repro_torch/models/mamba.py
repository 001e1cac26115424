"""Mamba2 (SSD) blocks and the zamba2-2.7b hybrid LM (mirrors
``src/repro/models/mamba.py``).

The SSD scan is the chunked (block-parallel) form of the Mamba2 paper: an
intra-chunk quadratic term plus an inter-chunk state recurrence.  zamba2
is a stack of Mamba2 layers with one shared attention + MLP block applied
at the start of every group of ``attn_every`` layers (one set of weights;
each application keeps its own KV cache).  ``a_log``, ``d_skip`` and
``dt_bias`` stay float32 at any model dtype.

On a mesh (``forward_sharded``, ``decode_step_sharded``) the shared block
is a dense block and runs on the dense family's tensor-parallel
functions; the Mamba2 mixer runs its SSD on a rank's heads in training
and on the cache's own slice of the SSM state in decode.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import partition as P
from repro_torch.tree import tree_map

__all__ = ["init_params", "forward", "init_cache", "decode_step",
           "prefill_chunk", "ssd_chunked", "ssd_step", "mamba2_apply",
           "mamba2_step", "mamba2_prefill", "forward_sharded",
           "decode_step_sharded", "tp_widths"]

GROUPS = 1                      # B/C projection groups


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_head_dim, cfg.ssm_state


def tp_widths(cfg: ModelConfig) -> tuple:
    """The dims the sharded steps split on ``model``: the shared block's
    dense widths and the Mamba2 mixer's (``in_proj``'s output columns,
    the conv channels, d_inner and the SSD heads)."""
    d_inner, n_heads, n = _dims(cfg)
    return T.tp_widths(cfg) + (2 * d_inner + 2 * GROUPS * n + n_heads,
                               d_inner + 2 * GROUPS * n, d_inner, n_heads)


# --------------------------------------------------------------------------
# SSD core
# --------------------------------------------------------------------------
def ssd_chunked(x, dt, a, bmat, cmat, chunk: int = 128, init_state=None):
    """Chunked selective-state-space scan.  x (B, S, H, P); dt (B, S, H)
    (post-softplus); a (H,) negative; bmat / cmat (B, S, G, N).  Returns
    (y (B, S, H, P) float32, final state (B, H, P, N) float32)."""
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
    sp = s + pad
    nc = sp // chunk
    rep = h // g

    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    bc = bmat.reshape(b, nc, chunk, g, n).float()
    cc = cmat.reshape(b, nc, chunk, g, n).float()

    cs = torch.cumsum(dtc * a.float(), dim=2)      # inclusive cumsum
    # intra-chunk: y[t] += sum_{j<=t} exp(cs[t]-cs[j]) (C_t.B_j) dt_j x_j
    cb = torch.repeat_interleave(torch.einsum("bctgn,bcjgn->bcgtj", cc, bc),
                                 rep, dim=2)          # G -> H heads
    cst = cs.permute(0, 1, 3, 2)                   # (B, nc, H, Lc)
    # exp(cs[t] - cs[j]) overflows above the diagonal: the exponent is
    # masked to -inf there before the exp, which gives the reference's
    # values (exp(-inf) = 0) and a zero gradient.  The reference selects
    # after the exp, whose backward multiplies the inf by the zero it
    # routes there: NaN grads once a chunk's decay overflows
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    diff = cst[..., :, None] - cst[..., None, :]
    dec = torch.exp(torch.where(tri, diff, torch.full_like(diff, -math.inf)))
    dx = dtc[..., None] * xc                       # (B, nc, Lc, H, P)
    y_intra = torch.einsum("bchtj,bcjhp->bcthp", cb * dec, dx)

    # chunk states: S_c = sum_j exp(cs[last]-cs[j]) dt_j x_j (x) B_j
    decay_to_end = torch.exp(cst[..., -1:] - cst)  # (B, nc, H, Lc)
    bfull = torch.repeat_interleave(bc, rep, dim=3)   # (B, nc, Lc, H, N)
    states = torch.einsum("bchl,bclhp,bclhn->bchpn", decay_to_end, dx,
                          bfull)

    # inter-chunk recurrence
    chunk_decay = torch.exp(cst[..., -1])          # (B, nc, H)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)         # (B, nc, H, P, N)

    # y_inter[t] = exp(cs[t]) * C_t . prev_state
    cfull = torch.repeat_interleave(cc, rep, dim=3)
    y_inter = torch.einsum("bclhn,bchpn,bchl->bclhp", cfull, prev_states,
                           torch.exp(cst))
    y = (y_intra + y_inter).reshape(b, sp, h, p)[:, :s]
    return y, state


def ssd_step(state, x_t, dt_t, a, b_t, c_t):
    """One-token SSD update.  state (B, H, P, N); x_t (B, H, P); dt_t
    (B, H); b_t / c_t (B, G, N) -> (y (B, H, P), new state)."""
    rep = x_t.shape[1] // b_t.shape[1]
    bf = torch.repeat_interleave(b_t, rep, dim=1)     # (B, H, N)
    cf = torch.repeat_interleave(c_t, rep, dim=1)
    da = torch.exp(dt_t.float() * a.float())
    state = (state * da[..., None, None]
             + torch.einsum("bhp,bhn->bhpn", dt_t[..., None] * x_t, bf))
    return torch.einsum("bhpn,bhn->bhp", state, cf), state


# --------------------------------------------------------------------------
# Mamba2 layer
# --------------------------------------------------------------------------
def init_mamba_layer(cfg: ModelConfig, gen, lead: tuple, dev) -> dict:
    d_inner, n_heads, n = _dims(cfg)
    conv_ch = d_inner + 2 * GROUPS * n
    proj_out = 2 * d_inner + 2 * GROUPS * n + n_heads
    d, dt, f32 = cfg.d_model, cfg.dtype, torch.float32
    return {
        "in_proj": T.normal(gen, lead + (d, proj_out), d ** -0.5, dt, dev),
        "conv_w": T.normal(gen, lead + (cfg.conv_kernel, conv_ch), 0.1, dt,
                           dev),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dt, device=dev),
        "a_log": torch.zeros(lead + (n_heads,), dtype=f32, device=dev),
        "d_skip": torch.ones(lead + (n_heads,), dtype=f32, device=dev),
        "dt_bias": torch.zeros(lead + (n_heads,), dtype=f32, device=dev),
        "norm_w": torch.ones(lead + (d_inner,), dtype=dt, device=dev),
        "out_proj": T.normal(gen, lead + (d_inner, d), d_inner ** -0.5, dt,
                             dev),
    }


def _split_proj(cfg: ModelConfig, z):
    d_inner, _, n = _dims(cfg)
    return (z[..., :d_inner], z[..., d_inner:2 * d_inner + 2 * GROUPS * n],
            z[..., 2 * d_inner + 2 * GROUPS * n:])


def _split_xbc(cfg: ModelConfig, xbc, lead: tuple):
    """xbc (..., conv_ch) -> x (lead, H, P), B and C (lead, G, N)."""
    d_inner, n_heads, n = _dims(cfg)
    return (xbc[..., :d_inner].reshape(lead + (n_heads, cfg.ssm_head_dim)),
            xbc[..., d_inner:d_inner + GROUPS * n].reshape(lead + (GROUPS, n)),
            xbc[..., d_inner + GROUPS * n:].reshape(lead + (GROUPS, n)))


def _causal_conv(xbc, w, b):
    """Depthwise causal conv over the sequence.  xbc (B, S, C); w (K, C)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i][None, None, :] for i in range(k))
    return out + b[None, None, :]


def _gated_out(cfg: ModelConfig, p: dict, y, xs, zg, x, proj=None):
    """The D skip, the gated RMS norm and the output projection (``proj``
    in place of ``out_proj``'s product where given)."""
    d_inner = _dims(cfg)[0]
    y = y + p["d_skip"].float()[:, None] * xs.float()
    y = y.reshape(x.shape[:2] + (d_inner,)).to(x.dtype)
    y = L.rms_norm(y * F.silu(zg), p["norm_w"], cfg.norm_eps)
    return L.dense(y, p["out_proj"]) if proj is None else proj(y)


def mamba2_apply(cfg: ModelConfig, p: dict, x, init_state=None):
    """x (B, S, D) -> (y, final ssm state)."""
    b, s, _ = x.shape
    zg, xbc, dt = _split_proj(cfg, L.dense(x, p["in_proj"]))
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs, bmat, cmat = _split_xbc(cfg, xbc, (b, s))
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    y, state = ssd_chunked(xs, dt, a, bmat, cmat, init_state=init_state)
    return _gated_out(cfg, p, y, xs, zg, x), state


def mamba2_step(cfg: ModelConfig, p: dict, x, conv_state, ssm_state):
    """One token.  x (B, 1, D); conv_state (B, K-1, C) raw xbc rows;
    ssm_state (B, H, P, N) -> (y, conv_state, ssm_state)."""
    b = x.shape[0]
    zg, xbc, dt = _split_proj(cfg, L.dense(x, p["in_proj"]))
    window = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)   # (B, K, C)
    out = (torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float())
           + p["conv_b"].float())
    xbc = F.silu(out)[:, None, :].to(x.dtype)
    xs, bmat, cmat = _split_xbc(cfg, xbc, (b,))
    dt = F.softplus(dt.float() + p["dt_bias"].float())[:, 0]
    a = -torch.exp(p["a_log"].float())
    y, ssm_state = ssd_step(ssm_state.float(), xs.float(), dt, a,
                            bmat.float(), cmat.float())
    return (_gated_out(cfg, p, y[:, None], xs[:, None], zg, x),
            window[:, 1:].to(conv_state.dtype), ssm_state)


def mamba2_prefill(cfg: ModelConfig, p: dict, x, conv_state, ssm_state,
                   valid, n_valid):
    """A C-token slab continuing from the cached state.  x (B, C, D);
    conv_state (B, K-1, Cch) raw xbc rows; ssm_state (B, H, P, N); valid
    (B, C) bool; n_valid (B,).  Pad positions pass the state through
    exactly: dt is 0 there, so the decay is exp(0) = 1 and dt·x vanishes;
    the new conv window ends at the last valid token.  Returns (y, new
    conv state, new ssm state)."""
    b, c, _ = x.shape
    k = p["conv_w"].shape[0]
    zg, xbc, dt = _split_proj(cfg, L.dense(x, p["in_proj"]))
    # the causal conv seeded with the cached window, accumulated in
    # float32 as mamba2_step's
    ext = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    ext_f, w_f = ext.float(), p["conv_w"].float()
    conv = (sum(ext_f[:, i:i + c, :] * w_f[i][None, None, :]
                for i in range(k)) + p["conv_b"].float())
    xbc_act = F.silu(conv).to(x.dtype)
    # the new window: ext rows n_valid .. n_valid + K - 2
    idx = (n_valid.long()[:, None]
           + torch.arange(k - 1, device=x.device)[None, :])
    new_conv = torch.take_along_dim(
        ext, idx[..., None].expand(-1, -1, ext.shape[-1]), dim=1)
    xs, bmat, cmat = _split_xbc(cfg, xbc_act, (b, c))
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    dt = torch.where(valid[:, :, None], dt, torch.zeros_like(dt))
    a = -torch.exp(p["a_log"].float())
    y, ssm_state = ssd_chunked(xs, dt, a, bmat, cmat,
                               init_state=ssm_state.float())
    return (_gated_out(cfg, p, y, xs, zg, x), new_conv.to(conv_state.dtype),
            ssm_state)


# --------------------------------------------------------------------------
# zamba2 hybrid LM
# --------------------------------------------------------------------------
def _n_apps(cfg: ModelConfig) -> int:
    """Applications of the shared attention block (one KV cache each)."""
    if not cfg.attn_every:
        return 0
    if cfg.n_layers % cfg.attn_every:
        raise ValueError("n_layers must be a multiple of attn_every")
    return cfg.n_layers // cfg.attn_every


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> dict:
    dev = resolve_device(device)
    gen = T._generator(generator, dev)
    n = (cfg.n_layers,)
    params = T.init_embed(cfg, gen, dev)
    params["layers"] = {"ln": T.init_norm(cfg, n, dev),
                        "mamba": init_mamba_layer(cfg, gen, n, dev)}
    if cfg.attn_every:
        params["shared_attn"] = {
            "ln1": T.init_norm(cfg, (), dev),
            "attn": T.init_attn_layer(cfg, gen, (), dev),
            "ln2": T.init_norm(cfg, (), dev),
            "mlp": T.init_mlp_layer(cfg, gen, (), dev)}
    return params


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device=None) -> dict:
    """The conv windows (L, B, K-1, C) in the compute dtype, the SSM
    states (L, B, H, P, N) float32 and, per application of the shared
    block, K / V (A, B, max_len, KV, hd)."""
    dev = resolve_device(device)
    d_inner, n_heads, n = _dims(cfg)
    conv_ch = d_inner + 2 * GROUPS * n
    cache = {
        "conv": torch.zeros((cfg.n_layers, batch_size, cfg.conv_kernel - 1,
                             conv_ch), dtype=cfg.cdtype, device=dev),
        "ssm": torch.zeros((cfg.n_layers, batch_size, n_heads,
                            cfg.ssm_head_dim, n), dtype=torch.float32,
                           device=dev),
        "len": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
    }
    napp = _n_apps(cfg)
    if napp:
        shape = (napp, batch_size, max_len, cfg.n_kv_heads, cfg.hd)
        cache["k"] = torch.zeros(shape, dtype=cfg.cdtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=cfg.cdtype, device=dev)
    return cache


def _shared_block(cfg: ModelConfig, shared: dict, h, attn):
    """The shared attention + MLP block; ``attn(p, hn)`` -> (out, ...)."""
    a, *kv = attn(shared["attn"], T._norm(cfg, shared["ln1"], h))
    h = h + a
    h = h + T.mlp_apply(cfg, shared["mlp"], T._norm(cfg, shared["ln2"], h))
    return h, kv


def _run(cfg: ModelConfig, params: dict, h, mamba, attn=None):
    """The hybrid layer loop: before layer i with i % attn_every == 0,
    the shared block as application i // attn_every (``attn(app, p, hn)``
    -> (out, *cache rows)); layer i through ``mamba(i, lp, hn)`` -> (out,
    *state rows).  Returns (h, [state rows a layer], [cache rows an
    application])."""
    shared = params.get("shared_attn")
    _n_apps(cfg)            # raises unless attn_every divides n_layers
    states, kvs = [], []
    for i in range(cfg.n_layers):
        if shared is not None and i % cfg.attn_every == 0:
            app = i // cfg.attn_every
            h, kv = _shared_block(cfg, shared, h,
                                  lambda p, hn, app=app: attn(app, p, hn))
            kvs.append(kv)
        lp = T.layer_slice(params["layers"], i)
        m, *st = mamba(i, lp["mamba"], T._norm(cfg, lp["ln"], h))
        h = h + m
        states.append(st)
    return h, states, kvs


def _stacked(states, kvs) -> dict:
    new = {"conv": torch.stack([s[0] for s in states]),
           "ssm": torch.stack([s[1] for s in states])}
    if kvs:
        new["k"] = torch.stack([kv[0] for kv in kvs])
        new["v"] = torch.stack([kv[1] for kv in kvs])
    return new


def forward(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    tokens = batch["tokens"].to(params["embed"].device)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    h = T.embed_tokens(cfg, params, tokens)
    shared = params.get("shared_attn")
    layers = T.layer_list(params["layers"], cfg.n_layers)

    def mamba_body(h, lp):
        return h + mamba2_apply(cfg, lp["mamba"], T._norm(cfg, lp["ln"], h))[0]

    if shared is None:
        body = T.remat_wrap(cfg, mamba_body)
        for lp in layers:
            h = body(h, lp)
        return T.logits_from_hidden(cfg, params, h)

    def attn(p, hn):
        return (T.attn_apply(cfg, p, hn, positions),)

    def group_body(h, group):
        # the reference's remat unit: the shared block, then its group
        h, _ = _shared_block(cfg, shared, h, attn)
        for lp in group:
            h = mamba_body(h, lp)
        return h

    body = T.remat_wrap(cfg, group_body)
    every = cfg.attn_every
    for g in range(_n_apps(cfg)):
        h = body(h, layers[g * every:(g + 1) * every])
    return T.logits_from_hidden(cfg, params, h)


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    tokens = batch["tokens"].to(params["embed"].device)
    h = T.embed_tokens(cfg, params, tokens)

    def mamba(i, p, hn):
        return mamba2_step(cfg, p, hn, cache["conv"][i], cache["ssm"][i])

    def attn(app, p, hn):
        return T.attn_decode_apply(cfg, p, hn, cache["k"][app],
                                   cache["v"][app], cache["len"])[:3]

    h, states, kvs = _run(cfg, params, h, mamba, attn)
    new = _stacked(states, kvs)
    new["len"] = cache["len"] + 1
    return T.logits_from_hidden(cfg, params, h), new


def prefill_chunk(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    """Chunked prefill, the contract of ``transformer.prefill_chunk``:
    tokens (B, C) at cache["len"].., and pad tokens past
    batch["n_valid"] leave every recurrent state untouched."""
    tokens = batch["tokens"].to(params["embed"].device)
    c = tokens.shape[1]
    start = cache["len"]
    n_valid = batch.get("n_valid")
    if n_valid is None:
        n_valid = torch.full_like(start, c)
    n_valid = n_valid.to(start.device)
    valid = (torch.arange(c, dtype=torch.int32, device=start.device)[None]
             < n_valid[:, None])
    h = T.embed_tokens(cfg, params, tokens)

    def mamba(i, p, hn):
        return mamba2_prefill(cfg, p, hn, cache["conv"][i], cache["ssm"][i],
                              valid, n_valid)

    def attn(app, p, hn):
        return T.attn_prefill_apply(cfg, p, hn, cache["k"][app],
                                    cache["v"][app], start)[:3]

    h, states, kvs = _run(cfg, params, h, mamba, attn)
    new = _stacked(states, kvs)
    new["len"] = start + n_valid
    return T.logits_from_hidden(cfg, params, h), new


# --------------------------------------------------------------------------
# zamba2 on a mesh: each rank's shards, explicit collectives
# --------------------------------------------------------------------------
def _mixer_tp(cfg: ModelConfig, p: dict, x, mesh):
    """The Mamba2 mixer under tensor parallelism, in training: ``x`` (B, S,
    D) inside the region (``copy_to``), ``p`` a layer's params gathered
    along ``data`` (``in_proj`` its output columns on ``model``,
    ``conv_w`` its channels, ``out_proj`` its rows; the rest
    replicated).  ``in_proj``'s and ``conv_w``'s splits straddle the z /
    xBC / dt segments, so the two leaves are gathered along ``model``
    here, inside the remat unit (their backward reduce-scatters the
    ranks' partial grads), and narrowed to the columns of this rank's
    SSD heads (``n_heads / model`` of them, as the reference's
    ``shard_hint``s place the heads) and every B / C column.  The SSD
    runs on those heads, the gated norm's mean of squares is summed
    over ``model`` (``psum``), and ``out_proj``'s rows (the same heads)
    give this rank's partial of the output, summed over ``model``.
    ``mamba2_apply`` on one rank."""
    if P.mesh_axis_size(mesh, "model") == 1:
        return mamba2_apply(cfg, p, x)[0]
    b, s, _ = x.shape
    d_inner, n_heads, n = _dims(cfg)
    pd, gn = cfg.ssm_head_dim, GROUPS * n
    lo, hi = T._model_part(mesh, n_heads)
    nh = hi - lo

    def span(a, z):
        return torch.arange(a, z, device=x.device)

    conv_idx = torch.cat([span(lo * pd, hi * pd),
                          span(d_inner, d_inner + 2 * gn)])
    proj_idx = torch.cat([span(lo * pd, hi * pd), d_inner + conv_idx,
                          span(2 * d_inner + 2 * gn + lo,
                               2 * d_inner + 2 * gn + hi)])
    rep = {k: P.copy_to(p[k], mesh)
           for k in ("conv_b", "a_log", "d_skip", "dt_bias", "norm_w")}
    w = P.gather_dim(p["in_proj"], 1, mesh, "model")
    cw = P.gather_dim(p["conv_w"], 1, mesh, "model")
    zg, xbc, dt = L.dense(x, w[:, proj_idx]).split(
        [nh * pd, nh * pd + 2 * gn, nh], dim=-1)
    xbc = F.silu(_causal_conv(xbc, cw[:, conv_idx], rep["conv_b"][conv_idx]))
    xs = xbc[..., :nh * pd].reshape(b, s, nh, pd)
    bmat = xbc[..., nh * pd:nh * pd + gn].reshape(b, s, GROUPS, n)
    cmat = xbc[..., nh * pd + gn:].reshape(b, s, GROUPS, n)
    dt = F.softplus(dt.float() + rep["dt_bias"][lo:hi].float())
    a = -torch.exp(rep["a_log"][lo:hi].float())
    y, _ = ssd_chunked(xs, dt, a, bmat, cmat)
    y = y + rep["d_skip"][lo:hi].float()[:, None] * xs.float()
    g = (y.reshape(b, s, nh * pd).to(x.dtype) * F.silu(zg)).float()
    var = P.psum(torch.sum(g * g, dim=-1, keepdim=True), mesh,
                 "model") / d_inner
    y = (g * torch.rsqrt(var + cfg.norm_eps)
         * rep["norm_w"][lo * pd:hi * pd].float()).to(x.dtype)
    return P.reduce_from(L.dense(y, p["out_proj"]), mesh)


def forward_sharded(cfg: ModelConfig, params: dict, batch: dict,
                    layout) -> torch.Tensor:
    """``forward`` on this rank's shards (``params`` the local tensors of a
    tree placed by ``layout``: ``param_pspecs``, FSDP on ``data``, TP on
    ``model``; ``batch`` this rank's part).  The remat unit is the
    reference's, the shared block and its group; each layer's params
    (and the shared block's, at each application) are all-gathered
    along ``data`` inside it (``fsdp_gather``).  The shared block runs
    the dense family's ``_attn_tp`` and a column / row-parallel MLP, the
    mixer ``_mixer_tp``; the embedding is vocab-parallel and the logits
    are left split on ``model``.  Returns this rank's logits (B_local, S,
    V / model).  Needs ``factory.shards``; on one rank it is
    ``forward``, bit for bit."""
    mesh, specs = layout.mesh, layout.specs

    tokens = batch["tokens"].to(params["embed"].device)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    embed = P.fsdp_gather(params["embed"], specs["embed"], mesh)
    h = T._embed_tp(cfg, embed, tokens, mesh)
    layers = T.layer_list(params["layers"], cfg.n_layers)
    lsp = tree_map(lambda sp: sp[1:], specs["layers"])
    shared = params.get("shared_attn")

    def mamba_body(h, lp):
        lp = T.fsdp_tree(lp, lsp, mesh)
        x = P.copy_to(T._norm(cfg, lp["ln"], h), mesh)
        return h + _mixer_tp(cfg, lp["mamba"], x, mesh)

    def group_body(h, group):
        if shared is not None:
            sh = T.fsdp_tree(shared, specs["shared_attn"], mesh)
            x = P.copy_to(T._norm(cfg, sh["ln1"], h), mesh)
            h = h + T._attn_tp(cfg, sh["attn"], x, positions, mesh)
            x = P.copy_to(T._norm(cfg, sh["ln2"], h), mesh)
            h = h + P.reduce_from(T.mlp_apply(cfg, sh["mlp"], x), mesh)
        for lp in group:
            h = mamba_body(h, lp)
        return h

    body = T.remat_wrap(cfg, group_body)
    # one remat unit a group, as ``forward`` (which rejects the same
    # configs), or a layer without the shared block
    every, n = ((cfg.attn_every, _n_apps(cfg)) if shared is not None
                else (1, cfg.n_layers))
    for g in range(n):
        h = body(h, layers[g * every:(g + 1) * every])
    top = {"embed": embed,
           "final_norm": T.fsdp_tree(params["final_norm"],
                                     specs["final_norm"], mesh)}
    return T.logits_from_hidden(cfg, top, h, mesh)


def _mixer_decode_tp(cfg: ModelConfig, p: dict, sp: dict, x, conv_state,
                     ssm_state, ssm_spec, mesh):
    """One token's Mamba2 mixer on this rank's weight and state shards at
    the serving layout (``sp``: ``in_proj``'s columns and ``conv_w``'s
    channels on ``model``, ``out_proj``'s rows; at ``global_batch == 1``
    ``in_proj``'s contraction and ``out_proj``'s output on ``data``).
    No param leaf moves; the activations do where a split straddles:

      * ``in_proj``: the partial products summed over its contraction
        axes, then its output columns all-gathered along ``model`` (B x
        ``in_proj``'s width);
      * the conv on the rank's channels of the window (the conv state's
        own slice), its output gathered along ``model`` (B x channels);
      * the SSD step on the SSM state's own slice ``ssm_spec`` (batch,
        heads, head dim P, N; P on ``model`` where it divides, else the
        heads), its output gathered (B x d_inner);
      * the D skip and the gated norm on every column, then
        ``out_proj``'s rows, summed over their axes.

    Returns (y (B, 1, D), the new conv state, the new SSM state), the
    states at their shards; on one rank ``mamba2_step``'s ops."""
    b = x.shape[0]
    c_ax = sp["in_proj"][-1]
    z = P.gather_along(T.proj_tp(p, sp, ((x, "in_proj"),), mesh)[0],
                       (None, None, c_ax), mesh, P.axis_names(c_ax))
    zg, xbc, dt = _split_proj(cfg, z)
    ch = (None, None, sp["conv_w"][-1])
    window = torch.cat([conv_state.to(xbc.dtype),
                        P.local_slice(xbc, ch, mesh)], dim=1)
    out = (torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float())
           + P.local_slice(p["conv_b"], ch[2:], mesh).float())
    xbc = P.gather_along(F.silu(out)[:, None, :].to(x.dtype), ch, mesh,
                         P.sharded_axes(ch, mesh))
    xs, bmat, cmat = _split_xbc(cfg, xbc, (b,))
    dt = F.softplus(dt.float() + p["dt_bias"].float())[:, 0]
    a = -torch.exp(p["a_log"].float())
    hp = (None,) + tuple(ssm_spec[1:3])
    y, ssm_state = ssd_step(
        ssm_state.float(), P.local_slice(xs.float(), hp, mesh),
        P.local_slice(dt, hp[:2], mesh), P.local_slice(a, hp[1:2], mesh),
        bmat.float(), cmat.float())
    y = P.gather_along(y, hp, mesh, P.sharded_axes(hp, mesh))
    r_ax, o_ax = sp["out_proj"]

    def proj(y):
        y = P.all_reduce(L.dense(P.local_slice(y, (None, None, r_ax), mesh),
                                 p["out_proj"]), mesh, r_ax)
        return P.gather_along(y, (None, None, o_ax), mesh,
                              P.axis_names(o_ax))

    return (_gated_out(cfg, p, y[:, None], xs[:, None], zg, x, proj),
            window[:, 1:].to(conv_state.dtype), ssm_state)


def decode_step_sharded(cfg: ModelConfig, params: dict, cache: dict,
                        batch: dict, playout, clayout, donate: bool = True):
    """``decode_step`` as tensor-parallel products on this rank's shards,
    the contract of ``transformer.decode_step_sharded`` (params at
    ``serve_param_pspecs``, the cache at ``cache_pspecs``: conv windows
    by channel and SSM states by head dim on ``model``, the shared
    block's K / V by KV heads or sequence): the embedding and logits and
    the shared block's attention and MLP are the dense family's, the
    mixer ``_mixer_decode_tp``.  Returns (logits, the new local cache,
    the logits' spec)."""
    mesh, ps, cs = playout.mesh, playout.specs, clayout.specs
    b_ax = cs["ssm"][1]
    h = T.decode_embed(cfg, params["embed"], ps["embed"][0], batch["tokens"],
                       mesh, b_ax)
    lens = P.local_slice(cache["len"], (b_ax,), mesh)
    lsp = tree_map(lambda sp: sp[1:], ps["layers"])
    shared, ssp = params.get("shared_attn"), ps.get("shared_attn")
    new = {n: [] for n in ("conv", "ssm", "k", "v") if n in cache}
    if shared is not None:
        attn = T.decode_attn(cfg, mesh, ssp["attn"], cs["k"],
                             cache["k"].shape, lens)
    for i in range(cfg.n_layers):
        if shared is not None and i % cfg.attn_every == 0:
            app = i // cfg.attn_every
            a, kc, vc, _, _ = attn(shared["attn"],
                                   T._norm(cfg, shared["ln1"], h),
                                   cache["k"][app], cache["v"][app])
            h = h + a
            h = h + T._mlp_tp(cfg, shared["mlp"], ssp["mlp"],
                              T._norm(cfg, shared["ln2"], h), mesh, b_ax)
            T.keep_row(cache["k"], new["k"], app, kc, donate)
            T.keep_row(cache["v"], new["v"], app, vc, donate)
        lp = T.layer_slice(params["layers"], i)
        m, conv, ssm = _mixer_decode_tp(
            cfg, lp["mamba"], lsp["mamba"], T._norm(cfg, lp["ln"], h),
            cache["conv"][i], cache["ssm"][i], cs["ssm"][1:], mesh)
        h = h + m
        T.keep_row(cache["conv"], new["conv"], i, conv, donate)
        T.keep_row(cache["ssm"], new["ssm"], i, ssm, donate)
    out = T.stacked_rows(cache, new, donate)
    out["len"] = cache["len"] + 1
    logits, lspec = T.decode_logits(cfg, params, ps, h, mesh, b_ax)
    return logits, out, lspec
