"""Mamba2 (SSD) blocks and the zamba2-2.7b hybrid LM (mirrors
``src/repro/models/mamba.py``).

The SSD scan is the chunked (block-parallel) form of the Mamba2 paper: an
intra-chunk quadratic term plus an inter-chunk state recurrence.  zamba2
is a stack of Mamba2 layers with one shared attention + MLP block applied
at the start of every group of ``attn_every`` layers (one set of weights;
each application keeps its own KV cache).  ``a_log``, ``d_skip`` and
``dt_bias`` stay float32 at any model dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

__all__ = ["init_params", "forward", "init_cache", "decode_step",
           "prefill_chunk", "ssd_chunked", "ssd_step", "mamba2_apply",
           "mamba2_step", "mamba2_prefill"]

GROUPS = 1                      # B/C projection groups


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_head_dim, cfg.ssm_state


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


def _gated_out(cfg: ModelConfig, p: dict, y, xs, zg, x):
    """The D skip, the gated RMS norm and the output projection."""
    d_inner = _dims(cfg)[0]
    y = y + p["d_skip"].float()[:, None] * xs.float()
    y = y.reshape(x.shape[:2] + (d_inner,)).to(x.dtype)
    y = L.rms_norm(y * F.silu(zg), p["norm_w"], cfg.norm_eps)
    return L.dense(y, p["out_proj"])


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
