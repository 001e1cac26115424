"""The plain reference against the port at tiny sizes on the CPU: the
weights it works out again (pruning, the int8 codes of the packed row
order) equal the port's own dequantized copies bit for bit, and its
forward agrees with the port's."""
from __future__ import annotations

import pytest
import torch

from perfbench.harness.plugins import load_module
from perfbench.reference import common, espim_pack, granite
from perfbench.reference.granite import (GROUPS, PROJECTIONS, make_weights,
                                         param_tree)

# (layers, d, heads, kv heads, head dim, ff, chunk columns, sparsity)
SHAPES = [(2, 128, 4, 2, 32, 256, 512, 0.9),
          (3, 128, 4, 2, 32, 192, 32, 0.9),
          (2, 96, 3, 1, 32, 320, 48, 0.75),
          (4, 64, 2, 2, 32, 128, 16, 0.5)]


def _dims(layers, d, heads, kv, hd, ff, vocab=512):
    return granite.Dims({"num_hidden_layers": layers, "hidden_size": d,
                         "num_attention_heads": heads,
                         "num_key_value_heads": kv, "head_dim": hd,
                         "intermediate_size": ff, "vocab_size": vocab,
                         "rope_theta": 1e4, "rms_norm_eps": 1e-5})


def _codes(quant):
    return None if quant is None else load_module("reference/codes", quant)


def _program_cfg(dims, dtype="float32"):
    from repro_torch.configs.registry import get_config
    return get_config("granite-3-2b", reduced=True).replace(
        n_layers=dims.layers, d_model=dims.d, n_heads=dims.heads,
        n_kv_heads=dims.kv_heads, head_dim=dims.hd, d_ff=dims.ff,
        vocab_size=dims.vocab, param_dtype=dtype, compute_dtype=dtype)


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_served_weights_equal_the_ports(shape, quant):
    from repro_torch.core.sparse_model import sparsify_model
    layers, d, heads, kv, hd, ff, cc, sparsity = shape
    dims = _dims(layers, d, heads, kv, hd, ff)
    cfg = _program_cfg(dims)
    w = make_weights(dims, cfg.padded_vocab, 17, "cpu", torch.float32)
    sparse = sparsify_model(cfg, param_tree(w), sparsity, chunk_cols=cc,
                            quant=quant, device="cpu")
    raw = {n: w[n] for n, *_ in PROJECTIONS}
    served, nnz = espim_pack.served_projections(raw, GROUPS, sparsity,
                                                _codes(quant), cc)
    for name, *_ in PROJECTIONS:
        assert torch.equal(served[name], sparse["pruned"][name]), name
        want = [int(c) for c in sparse[_group_of(name)]["proj_nnz"][name]]
        assert nnz[name] == want, name


def _group_of(proj: str) -> str:
    return next(g for g, projs, *_ in GROUPS if proj in projs)


def test_bf16_weights_prune_as_the_port_does():
    from repro_torch.core.sparse_model import sparsify_model
    dims = _dims(2, 128, 4, 2, 32, 256)
    cfg = _program_cfg(dims, "bfloat16")
    w = make_weights(dims, cfg.padded_vocab, 3, "cpu", torch.bfloat16)
    sparse = sparsify_model(cfg, param_tree(w), 0.9, quant="int8",
                            device="cpu")
    raw = {n: w[n] for n, *_ in PROJECTIONS}
    served, _ = espim_pack.served_projections(raw, GROUPS, 0.9,
                                              _codes("int8"), 512)
    for name, *_ in PROJECTIONS:
        assert torch.equal(served[name].to(torch.bfloat16),
                           sparse["pruned"][name]), name


def test_width_plan_matches_the_ports():
    from repro_torch.core.sdds import plan_width_buckets
    gen = torch.Generator().manual_seed(5)
    for n in (1, 3, 17, 40):
        widths = torch.randint(0, 60, (n,), generator=gen).tolist()
        widths.sort(reverse=True)
        want = plan_width_buckets(widths, rows_per_group=32)
        assert espim_pack.plan_width_buckets(widths, 32) == \
            [tuple(b) for b in want.boundaries]


def test_forward_agrees_with_the_ports():
    from repro_torch.models.transformer import forward
    dims = _dims(2, 128, 4, 2, 32, 256)
    cfg = _program_cfg(dims)
    w = make_weights(dims, cfg.padded_vocab, 9, "cpu", torch.float32)
    tokens = torch.randint(0, dims.vocab, (37,),
                           generator=torch.Generator().manual_seed(1))
    with common.fp32_exact(), torch.no_grad():
        ref = granite.forward_logits(w, dims, tokens, first=5)
        port = forward(cfg, param_tree(w), {"tokens": tokens[None]})[0]
    port = port[5:, :dims.vocab].float()
    err = (ref - port).abs().max() / ref.abs().max()
    assert err < 1e-5, float(err)


def test_gaps_and_controls():
    logits = torch.tensor([[1.0, 3.0, 2.0], [0.5, 0.1, 0.4]])
    gaps = common.serve_gaps(logits, torch.tensor([2, 0]))
    assert gaps.tolist() == [1.0, 0.0]
    w = torch.tensor([[1.0, -0.5], [0.25, 2.0]])
    q8 = common.quantize_rows_int8(w, dim=0)
    assert torch.allclose(q8, w, rtol=0, atol=2.0 / 127 / 2 + 1e-7)
    f8 = common.quantize_rows_fp8(w, dim=0)
    assert f8[0, 0] == 1.0 and f8[1, 1] == 2.0


def test_forward_applies_the_configurations_multipliers():
    """Multipliers at the values the program implies leave the forward as
    it is; granite's published ones change it, as they should."""
    dims = _dims(2, 64, 2, 1, 32, 128, vocab=96)
    w = {k: v.float() for k, v in make_weights(dims, 96, 4, "cpu",
                                               torch.float32).items()}
    tokens = torch.arange(11) % 96
    implied = granite.Dims(dict(
        _model_of(dims), **granite.program_implied(dims)))
    published = granite.Dims(dict(
        _model_of(dims), embedding_multiplier=12.0,
        attention_multiplier=0.015625, residual_multiplier=0.22,
        logits_scaling=8.0))
    with common.fp32_exact(), torch.no_grad():
        base = granite.forward_logits(w, dims, tokens)
        same = granite.forward_logits(w, implied, tokens)
        other = granite.forward_logits(w, published, tokens)
    assert torch.allclose(base, same, rtol=1e-6, atol=1e-6)
    assert not torch.allclose(base, other, rtol=1e-2, atol=1e-2)


def _model_of(dims):
    return {"num_hidden_layers": dims.layers, "hidden_size": dims.d,
            "num_attention_heads": dims.heads,
            "num_key_value_heads": dims.kv_heads, "head_dim": dims.hd,
            "intermediate_size": dims.ff, "vocab_size": dims.vocab,
            "rope_theta": dims.theta, "rms_norm_eps": dims.eps}
