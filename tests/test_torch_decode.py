"""The port's sparse decode and chunked prefill against the JAX package's,
on the same params and packs (smoke llama7b-espim, float32, CPU).

Tolerance rtol = atol = 1e-4: XLA and torch sum the projections and the
attention contractions in different orders, and the error compounds over
layers and steps."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import sparse_model as RSM  # noqa: E402
from repro.models import factory  # noqa: E402

from _torch_parity import smoke_model, to_np  # noqa: E402
from repro_torch.core import sparse_model as PSM  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
B, STEPS = 3, 5


def _pair(quant, projections="all"):
    cfg, pcfg, params, tparams = smoke_model(n_layers=2)
    rs = RSM.sparsify_model(cfg, params, 0.9, projections=projections,
                            quant=quant)
    ps = PSM.sparsify_model(pcfg, tparams, 0.9, projections=projections,
                            quant=quant, device="cpu")
    return cfg, pcfg, params, tparams, rs, ps


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_decode_matches_reference(quant):
    cfg, pcfg, params, tparams, rs, ps = _pair(quant)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, STEPS))
    rc = factory.init_cache(cfg, B, STEPS + 2)
    pc = PT.init_cache(pcfg, B, STEPS + 2, device="cpu")
    ref_step = jax.jit(lambda p, c, b: RSM.decode_step_sparse(cfg, p, rs,
                                                              c, b))
    for s in range(STEPS):
        tk = toks[:, s:s + 1].astype(np.int32)
        rl, rc = ref_step(params, rc, {"tokens": jnp.asarray(tk)})
        pl, pc = PSM.decode_step_sparse(pcfg, tparams, ps, pc,
                                        {"tokens": torch.from_numpy(tk)},
                                        device="cpu")
        np.testing.assert_allclose(to_np(pl), to_np(rl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(to_np(pc[name]), to_np(rc[name]), **TOL)
    np.testing.assert_array_equal(pc["len"].numpy(), np.asarray(rc["len"]))


@pytest.mark.parametrize("proj_path", ["dense", "kernel"])
def test_prefill_matches_reference(proj_path):
    cfg, pcfg, params, tparams, rs, ps = _pair("int8")
    c, n_valid = 6, 5
    tk = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, c))
    tk = tk.astype(np.int32)
    rc = factory.init_cache(cfg, 1, 12)
    pc = PT.init_cache(pcfg, 1, 12, device="cpu")
    rl, rc = RSM.prefill_chunk_sparse(
        cfg, params, rs, rc, {"tokens": jnp.asarray(tk),
                              "n_valid": jnp.asarray([n_valid], jnp.int32)},
        proj_path=proj_path)
    pl, pc = PSM.prefill_chunk_sparse(
        pcfg, tparams, ps, pc, {"tokens": torch.from_numpy(tk),
                                "n_valid": torch.tensor([n_valid],
                                                        dtype=torch.int32)},
        proj_path=proj_path, device="cpu")
    np.testing.assert_allclose(to_np(pl), to_np(rl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(to_np(pc[name]), to_np(rc[name]), **TOL)
    assert int(pc["len"][0]) == int(rc["len"][0]) == n_valid


def test_mlp_only_decode_matches_reference():
    """projections="mlp": attention runs dense from the layer params."""
    cfg, pcfg, params, tparams, rs, ps = _pair("int8", projections="mlp")
    tk = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 1))
    tk = tk.astype(np.int32)
    rl, _ = RSM.decode_step_sparse(cfg, params, rs,
                                   factory.init_cache(cfg, B, 4),
                                   {"tokens": jnp.asarray(tk)})
    pl, _ = PSM.decode_step_sparse(pcfg, tparams, ps,
                                   PT.init_cache(pcfg, B, 4, device="cpu"),
                                   {"tokens": torch.from_numpy(tk)},
                                   device="cpu")
    np.testing.assert_allclose(to_np(pl), to_np(rl), **TOL)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_fused_epilogue_bit_identical_to_unfused(quant):
    """Inside the port the fused gate+up epilogue replays the unfused op
    order, so decode logits and caches are bit-identical."""
    _, pcfg, _, tparams, _, ps = _pair(quant)
    tk = torch.from_numpy(
        np.random.default_rng(4).integers(0, pcfg.vocab_size, (B, 1))
        .astype(np.int32))
    cache = PT.init_cache(pcfg, B, 4, device="cpu")
    outs = [PSM.decode_step_sparse(pcfg, tparams, ps, cache, {"tokens": tk},
                                   epilogue=ep, device="cpu")
            for ep in (True, False)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1]["k"], outs[1][1]["k"])
    assert torch.equal(outs[0][1]["v"], outs[1][1]["v"])


@pytest.mark.parametrize("quant", [None, "int8"])
def test_bucket_launches_share_one_contiguous_x_per_group(quant,
                                                          monkeypatch):
    """Each group's buckets go out as one grouped call a layer (one launch
    on the card), and each group casts and transposes its activations
    once: the call gets a contiguous fp32 x, so the kernel wrapper copies
    nothing; no per-bucket call is left on the decode path."""
    _, pcfg, _, tparams, _, ps = _pair(quant)
    seen, per_bucket = [], []

    def spy(fn, log, xi):
        def wrapped(*args, **kw):
            x = args[xi]
            log.append((x.dtype, x.is_contiguous(), x.data_ptr(),
                        len(args[0]) if log is seen else 1))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(PSM.ops, "espim_spmv_group",
                        spy(PSM.ops.espim_spmv_group, seen, 2))
    monkeypatch.setattr(PSM.ops, "espim_spmv_batched",
                        spy(PSM.ops.espim_spmv_batched, per_bucket, 2))
    monkeypatch.setattr(PSM.ops, "espim_spmv_batched_quant",
                        spy(PSM.ops.espim_spmv_batched_quant, per_bucket, 3))
    tk = torch.zeros((B, 1), dtype=torch.int32)
    PSM.decode_step_sparse(pcfg, tparams, ps,
                           PT.init_cache(pcfg, B, 4, device="cpu"),
                           {"tokens": tk}, device="cpu")
    assert not per_bucket
    # qkv, attn_out, gateup, down: one call a group a layer, each call
    # over all of its group's buckets
    assert len(seen) == pcfg.n_layers * len(ps["groups"])
    n_buckets = sum(len(g["buckets"]) for g in ps["groups"].values())
    assert sum(n for *_, n in seen) == pcfg.n_layers * n_buckets
    assert all(d == torch.float32 and c for d, c, _, _ in seen)
    assert len({p for _, _, p, _ in seen}) <= len(seen)


def test_decode_leaves_input_cache_unchanged():
    _, pcfg, _, tparams, _, ps = _pair(None)
    cache = PT.init_cache(pcfg, B, 4, device="cpu")
    tk = torch.zeros((B, 1), dtype=torch.int32)
    PSM.decode_step_sparse(pcfg, tparams, ps, cache, {"tokens": tk},
                           device="cpu")
    assert not cache["k"].any() and not cache["v"].any()
    assert not cache["len"].any()


def test_pruned_param_tree_swaps_covered_projections():
    _, pcfg, _, tparams, _, ps = _pair("int8")
    tree = PSM.pruned_param_tree(tparams, ps)
    for module, name in (("attn", "wq"), ("attn", "wo"), ("mlp", "w_gate"),
                         ("mlp", "w_down")):
        assert tree["layers"][module][name] is ps["pruned"][name]
    assert tparams["layers"]["attn"]["wq"] is not ps["pruned"]["wq"]
