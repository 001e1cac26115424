"""The ``granite`` family: IBM Granite 3.0's dense decoder, as a
configuration file with ``"family": "granite"`` names it.

The harness finds everything it needs of a family here, by the file's
name: the sizes (``Dims``), the seed's weights and the program's
parameter tree over them, the pack groups of the ESPIM deployment, the
weights each group's product reads (for the work counts), the program's
configuration fields, and the plain forward that decides ``correct``.

The forward is float32 (TF32 off), one sequence at a time over its whole
length, so the logits at every position come from one causal pass: token
embedding (times ``embedding_multiplier``), then per layer RMSNorm,
grouped-query attention with rotate-half RoPE (scores times
``attention_multiplier``), a residual add (the branch times
``residual_multiplier``), RMSNorm, a gated SiLU MLP and a residual add; a
final RMSNorm and the tied embedding as the vocab projection (divided by
``logits_scaling``).  The multipliers are read from the configuration;
the program runs granite without them, so its files state the values
that leave them out (``PROGRAM_IMPLIED``).
"""
from __future__ import annotations

import math

import torch

from perfbench.harness.weights import Draw
from perfbench.reference.common import CONTROL_CODES, rms, rope

__all__ = ["Dims", "PROGRAM_FIELDS", "program_implied", "PROJECTIONS",
           "GROUPS", "make_weights", "param_tree", "group_shapes",
           "dense_weights", "forward_logits", "control_weights"]

# configuration file key -> the program's ModelConfig field
PROGRAM_FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
                  "num_attention_heads": "n_heads",
                  "num_key_value_heads": "n_kv_heads", "head_dim": "hd",
                  "intermediate_size": "d_ff", "vocab_size": "vocab_size",
                  "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
                  "tie_word_embeddings": "tie_embeddings",
                  "hidden_act": "activation", "torch_dtype": "compute_dtype"}

# (leaf, module, shape from (d, heads*hd, kv*hd, ff), fan-in)
PROJECTIONS = (("wq", "attn", lambda d, q, kv, f: (d, q), "d"),
               ("wk", "attn", lambda d, q, kv, f: (d, kv), "d"),
               ("wv", "attn", lambda d, q, kv, f: (d, kv), "d"),
               ("wo", "attn", lambda d, q, kv, f: (q, d), "q"),
               ("w_gate", "mlp", lambda d, q, kv, f: (d, f), "d"),
               ("w_up", "mlp", lambda d, q, kv, f: (d, f), "d"),
               ("w_down", "mlp", lambda d, q, kv, f: (f, d), "f"))

# the decoder layer's pack groups: (name, projections, module, fuse,
# the group whose packed row order this group's columns follow)
GROUPS = (("qkv", ("wq", "wk", "wv"), "attn", "concat", None),
          ("attn_out", ("wo",), "attn", "concat", None),
          ("gateup", ("w_gate", "w_up"), "mlp", "halves", None),
          ("down", ("w_down",), "mlp", "concat", "gateup"))

NORM_SPREAD = 0.1
EMBED_STD = 0.02


class Dims:
    """The sizes a forward needs, read from a configuration file's
    ``model`` section (Hugging Face key names)."""

    def __init__(self, model: dict):
        self.layers = int(model["num_hidden_layers"])
        self.d = int(model["hidden_size"])
        self.heads = int(model["num_attention_heads"])
        self.kv_heads = int(model["num_key_value_heads"])
        self.hd = int(model.get("head_dim") or self.d // self.heads)
        self.ff = int(model["intermediate_size"])
        self.vocab = int(model["vocab_size"])
        self.theta = float(model["rope_theta"])
        self.eps = float(model["rms_norm_eps"])
        self.embed_mult = float(model.get("embedding_multiplier", 1.0))
        self.attn_mult = float(model.get("attention_multiplier",
                                         self.hd ** -0.5))
        self.resid_mult = float(model.get("residual_multiplier", 1.0))
        self.logits_scaling = float(model.get("logits_scaling", 1.0))


def program_implied(dims: Dims) -> dict:
    """The configuration keys the program has no field for, at the values
    it always runs with."""
    return {"embedding_multiplier": 1.0, "attention_multiplier": dims.hd
            ** -0.5, "residual_multiplier": 1.0, "logits_scaling": 1.0}


def make_weights(dims: Dims, table_rows: int, seed: int, device,
                 dtype=torch.bfloat16) -> dict:
    """{leaf: tensor}, made on ``device`` from the seed in the type they
    are served in: the projections stacked (L, in, out), N(0, 1 / fan_in);
    ``ln1`` / ``ln2`` (L, d) and ``final_norm`` (d,), 1 + N(0, 0.1^2), so
    the check sees the norms' weights too; ``embed`` (table_rows, d),
    N(0, 0.02^2), its rows past the vocabulary (which only pad the table)
    zero."""
    draw = Draw(seed, device, dtype)
    d, q, kv = dims.d, dims.heads * dims.hd, dims.kv_heads * dims.hd
    fan = {"d": d, "q": q, "f": dims.ff}
    out = {}
    for name, _module, shape, fan_in in PROJECTIONS:
        out[name] = draw((dims.layers,) + shape(d, q, kv, dims.ff),
                         fan[fan_in] ** -0.5)
    out["ln1"] = draw((dims.layers, d), NORM_SPREAD, 1.0)
    out["ln2"] = draw((dims.layers, d), NORM_SPREAD, 1.0)
    out["embed"] = draw((table_rows, d), EMBED_STD)
    out["embed"][dims.vocab:] = 0
    out["final_norm"] = draw((d,), NORM_SPREAD, 1.0)
    return out


def param_tree(w: dict) -> dict:
    """The served program's parameter tree over the same tensors."""
    layers = {"ln1": {"w": w["ln1"]}, "ln2": {"w": w["ln2"]},
              "attn": {}, "mlp": {}}
    for name, module, _shape, _fan in PROJECTIONS:
        layers[module][name] = w[name]
    return {"layers": layers, "embed": w["embed"],
            "final_norm": {"w": w["final_norm"]}}


def group_shapes(dims: Dims) -> dict:
    """{group: (projections, input width, output width, rows the weights
    have)} for one decoder layer."""
    d, f = dims.d, dims.ff
    q, kv = dims.heads * dims.hd, dims.kv_heads * dims.hd
    return {"qkv": (("wq", "wk", "wv"), d, q + 2 * kv, q + 2 * kv),
            "attn_out": (("wo",), q, d, d),
            "gateup": (("w_gate", "w_up"), d, f, 2 * f),
            "down": (("w_down",), f, d, d)}


def dense_weights(dims: Dims) -> dict:
    """{projection: [weights, one count per layer]} of the dense model."""
    d, q, kv = dims.d, dims.heads * dims.hd, dims.kv_heads * dims.hd
    return {name: [math.prod(shape(d, q, kv, dims.ff))] * dims.layers
            for name, _module, shape, _fan in PROJECTIONS}


def forward_logits(w: dict, dims: Dims, tokens: torch.Tensor,
                   first: int = 0) -> torch.Tensor:
    """Logits (S - first, vocab) float32 at positions first..S-1 of one
    sequence ``tokens`` (S,).  ``w`` holds float32 weights: ``embed``
    (>= vocab, d), ``final_norm`` (d,), and per layer, stacked on a
    leading axis, ``ln1`` / ``ln2`` (L, d) and the projections ``wq``
    (L, d, H*hd), ``wk`` / ``wv`` (L, d, KV*hd), ``wo`` (L, H*hd, d),
    ``w_gate`` / ``w_up`` (L, d, F), ``w_down`` (L, F, d)."""
    s = tokens.shape[0]
    dev = w["embed"].device
    tokens = tokens.to(dev).long()
    pos = torch.arange(s, device=dev)
    rep = dims.heads // dims.kv_heads
    causal = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    h = w["embed"][tokens] * dims.embed_mult
    for l in range(dims.layers):
        x = rms(h, w["ln1"][l], dims.eps)
        q = (x @ w["wq"][l]).view(s, dims.heads, dims.hd)
        k = (x @ w["wk"][l]).view(s, dims.kv_heads, dims.hd)
        v = (x @ w["wv"][l]).view(s, dims.kv_heads, dims.hd)
        q, k = rope(q, pos, dims.theta), rope(k, pos, dims.theta)
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        scores = torch.einsum("qhd,khd->hqk", q, k) * dims.attn_mult
        scores = scores.masked_fill(~causal, float("-inf"))
        p = torch.softmax(scores, dim=-1)
        o = torch.einsum("hqk,khd->qhd", p, v).reshape(s, -1)
        h = h + (o @ w["wo"][l]) * dims.resid_mult
        x = rms(h, w["ln2"][l], dims.eps)
        g = x @ w["w_gate"][l]
        h = h + ((torch.nn.functional.silu(g) * (x @ w["w_up"][l]))
                 @ w["w_down"][l]) * dims.resid_mult
    h = rms(h[first:], w["final_norm"], dims.eps)
    return (h @ w["embed"][:dims.vocab].T) / dims.logits_scaling


def control_weights(w: dict, code: str) -> dict:
    """The reference's weights with every matrix product's weights (the
    projections and the tied embedding) coded to ``code``, one scale per
    output channel; the rest as they are."""
    fn = CONTROL_CODES[code]
    out = dict(w)
    for name, *_ in PROJECTIONS:
        out[name] = fn(w[name], dim=1)
    out["embed"] = fn(w["embed"], dim=1)
    return out
