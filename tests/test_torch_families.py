"""The port's other model families against the JAX package's: MoE
(dbrx-132b, phi3.5-moe), the VLM with M-RoPE (qwen2-vl-2b), the Whisper
encoder-decoder, RWKV6 and the zamba2 hybrid, at the reduced configs in
float32 with the reference's params carried across.

Tolerances: logits, the MoE aux term and chunked prefill within 5e-5
relative to max|reference| (the reference's own decode-vs-forward
bound); the cross caches, ``moe_block`` and ``flash_attention`` within
1e-5; ``apply_mrope`` and ``layer_norm`` within 1e-6."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import get_config as ref_config  # noqa: E402
from repro.models import factory as RF  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro.models import whisper as RW  # noqa: E402

from _torch_parity import to_np  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import (FP32_LEAVES, cast_params,  # noqa: E402
                                 params_from_numpy)
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.models import factory as PF  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import moe as PMOE  # noqa: E402
from repro_torch.models import whisper as PW  # noqa: E402

ARCHS = ["dbrx-132b", "phi3.5-moe-42b-a6.6b", "qwen2-vl-2b",
         "whisper-small", "rwkv6-1.6b", "zamba2-2.7b"]
CHUNKED = ["rwkv6-1.6b", "zamba2-2.7b"]
REL = 5e-5
B, S = 2, 12


def _rel(got, want) -> float:
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    cfg = ref_config(arch, reduced=True)
    pcfg = get_config(arch, reduced=True)
    params = RF.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return cfg, pcfg, params, tparams


def _batch(cfg, seed=0, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (B, s)).astype(np.int32)
    ref, port = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "audio":
        fr = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)
                                 ).astype(np.float32)
        ref["frames"], port["frames"] = jnp.asarray(fr), torch.from_numpy(fr)
    return ref, port


def _leaves(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{pre}{k}/"))
        else:
            out[pre + k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_gives_the_reference_tree(arch):
    """Keys, shapes and dtypes at a bf16 model dtype, where the leaves the
    reference keeps float32 must stay float32."""
    cfg = ref_config(arch, reduced=True).replace(param_dtype="bfloat16")
    pcfg = get_config(arch, reduced=True).replace(param_dtype="bfloat16")
    want = _leaves(jax.eval_shape(
        lambda: RF.init_params(cfg, jax.random.PRNGKey(0))))
    got = _leaves(PF.init_params(pcfg, torch.Generator().manual_seed(0),
                                 device="cpu"))
    assert got == want
    f32 = {k for k, (_, dt) in want.items() if dt == "float32"}
    assert {k.rsplit("/", 1)[-1] for k in f32} <= FP32_LEAVES


@pytest.mark.parametrize("arch", ARCHS)
def test_cast_keeps_the_fp32_leaves(arch):
    _, _, params, tparams = _model(arch)
    cast = cast_params(tparams, dtype=torch.bfloat16)
    carried = params_from_numpy(jax.tree.map(np.asarray, params), "cpu",
                                dtype=torch.bfloat16)
    for tree in (cast, carried):
        for name, (_, dt) in _leaves(tree).items():
            want = ("float32" if name.rsplit("/", 1)[-1] in FP32_LEAVES
                    else "bfloat16")
            assert dt == want, name


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_train_matches_reference(arch):
    cfg, pcfg, params, tparams = _model(arch)
    rb, pb = _batch(cfg)
    rl, ra = jax.jit(functools.partial(RF.apply_train, cfg))(params, rb)
    pl, pa = PF.apply_train(pcfg, tparams, pb)
    assert _rel(pl, rl) <= REL
    assert abs(float(pa) - float(ra)) <= REL * max(1.0, abs(float(ra)))
    if cfg.family == "moe":
        assert float(pa) > 0


def _primed(cfg, pcfg, params, tparams, rb, pb, max_len):
    rc = RF.init_cache(cfg, B, max_len)
    pc = PF.init_cache(pcfg, B, max_len, "cpu")
    if cfg.family == "audio":
        rc = RW.prime_cross(cfg, params, rc, rb["frames"])
        pc = PW.prime_cross(pcfg, tparams, pc, pb["frames"])
    return rc, pc


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_and_forward(arch):
    """12 teacher-forced decode steps: each step's logits against the
    reference's step and against the port's own forward at that
    position."""
    cfg, pcfg, params, tparams = _model(arch)
    rb, pb = _batch(cfg)
    rc, pc = _primed(cfg, pcfg, params, tparams, rb, pb, S + 4)
    fwd, _ = PF.apply_train(pcfg, tparams, pb)
    step = jax.jit(functools.partial(RF.decode_step, cfg))
    for s in range(S):
        rl, rc = step(params, rc, {"tokens": rb["tokens"][:, s:s + 1]})
        pl, pc = PF.decode_step(pcfg, tparams, pc,
                                {"tokens": pb["tokens"][:, s:s + 1]})
        assert _rel(pl, rl) <= REL, s
        assert _rel(pl[:, 0], fwd[:, s]) <= REL, s
    for name in pc:
        want = to_np(rc[name])
        np.testing.assert_allclose(to_np(pc[name]), want, rtol=REL,
                                   atol=REL * max(1.0, np.abs(want).max()))


def _chunked(mod_prefill, mod_decode, cache, tokens, n_prompt, chunk=8):
    """Prefill ``tokens[:, :n_prompt]`` in chunks of ``chunk`` (the last
    padded), then one decode step on the next token -> (last-prompt
    logits, first-decode logits)."""
    pos, last = 0, None
    while pos < n_prompt:
        n = min(chunk, n_prompt - pos)
        toks = tokens[:, pos:pos + n]
        pad = chunk - n
        if pad:
            toks = (jnp.pad(toks, ((0, 0), (0, pad))) if isinstance(
                toks, jax.Array) else torch.nn.functional.pad(toks, (0, pad)))
        nv = [n] * B
        nv = (jnp.asarray(nv, jnp.int32) if isinstance(toks, jax.Array)
              else torch.tensor(nv, dtype=torch.int32))
        logits, cache = mod_prefill(cache, {"tokens": toks, "n_valid": nv})
        last = logits[:, n - 1]
        pos += n
    logits, _ = mod_decode(cache, {"tokens": tokens[:, n_prompt:n_prompt + 1]})
    return last, logits[:, 0]


@pytest.mark.parametrize("arch", CHUNKED)
def test_prefill_chunk_matches_reference_and_replay(arch):
    cfg, pcfg, params, tparams = _model(arch)
    rb, pb = _batch(cfg, seed=1)
    n_prompt = 11                        # two chunks, the second padded
    rc, pc = _primed(cfg, pcfg, params, tparams, rb, pb, S + 8)
    ref = _chunked(lambda c, b: RF.prefill_chunk(cfg, params, c, b),
                   lambda c, b: RF.decode_step(cfg, params, c, b),
                   rc, rb["tokens"], n_prompt)
    port = _chunked(lambda c, b: PF.prefill_chunk(pcfg, tparams, c, b),
                    lambda c, b: PF.decode_step(pcfg, tparams, c, b),
                    pc, pb["tokens"], n_prompt)
    for got, want in zip(port, ref):
        assert _rel(got, want) <= REL
    # the port's replay: the prompt token by token through decode_step
    for s in range(n_prompt + 1):
        lg, pc = PF.decode_step(pcfg, tparams, pc,
                                {"tokens": pb["tokens"][:, s:s + 1]})
        if s == n_prompt - 1:
            assert _rel(port[0], lg[:, 0]) <= REL
    assert _rel(port[1], lg[:, 0]) <= REL


def test_prime_cross_matches_reference():
    cfg, pcfg, params, tparams = _model("whisper-small")
    rb, pb = _batch(cfg)
    rc, pc = _primed(cfg, pcfg, params, tparams, rb, pb, 8)
    for name in ("cross_k", "cross_v"):
        np.testing.assert_allclose(to_np(pc[name]), to_np(rc[name]),
                                   rtol=1e-5, atol=1e-5)
    enc = PW.encode(pcfg, tparams, pb["frames"])
    np.testing.assert_allclose(
        to_np(enc), to_np(RW.encode(cfg, params, rb["frames"])),
        rtol=1e-5, atol=1e-5)


def test_moe_block_drops_as_the_reference():
    """capacity_factor 1.25 with a router that sends every token to expert
    0 first, and experts 2 and 3 tied: the expert overflows (drops) and
    top-k must break the tie toward expert 2, as ``jax.lax.top_k``; the
    80 tokens also leave a padded second group of 64."""
    cfg, pcfg, params, tparams = _model("phi3.5-moe-42b-a6.6b")
    cfg, pcfg = (c.replace(capacity_factor=1.25) for c in (cfg, pcfg))
    p = {k: np.array(v[0]) for k, v in params["layers"]["moe"].items()}
    d = cfg.d_model
    p["router"][:, 0] = 4.0 / np.sqrt(d)
    p["router"][:, 3] = p["router"][:, 2]
    x = (np.random.default_rng(5).standard_normal((2, 40, d)) + 1.0
         ).astype(np.float32)
    ry, raux = RMOE.moe_block(cfg, jax.tree.map(jnp.asarray, p),
                              jnp.asarray(x))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    py, paux = PMOE.moe_block(pcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(to_np(py), to_np(ry), rtol=1e-5, atol=1e-5)
    assert abs(float(paux) - float(raux)) <= 1e-5
    # drops were forced: expert 0 takes 40 of the first group's 64 tokens
    tg = cfg.moe_group_size
    assert PMOE.capacity(pcfg, tg) == 40
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, d))[:tg]
                          @ tp["router"], dim=-1)
    assert bool((probs.argmax(-1) == 0).all())
    _, top_e = PMOE._top_k(probs, 2)
    tie = torch.isclose(probs[:, 2], probs[:, 3]) & (top_e[:, 1] >= 2)
    assert bool(tie.any()) and bool((top_e[tie, 1] == 2).all())


@pytest.mark.parametrize("hd", [32, 128])
def test_apply_mrope_matches_reference(hd):
    rng = np.random.default_rng(hd)
    q = rng.standard_normal((2, 7, 4, hd)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, hd)).astype(np.float32)
    pos3 = rng.integers(0, 50, (3, 2, 7)).astype(np.int32)
    rq, rk = RL.apply_mrope(jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(pos3), 1e6)
    pq, pk = PL.apply_mrope(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(pos3), 1e6)
    np.testing.assert_allclose(to_np(pq), to_np(rq), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_np(pk), to_np(rk), rtol=1e-6, atol=1e-6)


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    want = RL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = PL.layer_norm(*(torch.from_numpy(a) for a in (x, w, b)))
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-6,
                               atol=1e-6)


FLASH_CASES = [  # (Sq, Skv, H, KV, causal, q_chunk, kv_chunk)
    (19, 19, 4, 4, True, 8, 8),
    (19, 19, 4, 2, False, 8, 16),
    (7, 30, 6, 2, True, 4, 8),          # unequal: end-aligned causal
    (7, 30, 4, 1, False, 64, 64),
    (33, 33, 8, 2, True, 512, 1024),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_reference(case):
    sq, skv, h, kv, causal, qc, kc = case
    rng = np.random.default_rng(sq * skv + h)
    q = rng.standard_normal((2, sq, h, 16)).astype(np.float32)
    k = rng.standard_normal((2, skv, kv, 16)).astype(np.float32)
    v = rng.standard_normal((2, skv, kv, 16)).astype(np.float32)
    want = RL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, q_chunk=qc, kv_chunk=kc)
    FA.reset_launches()
    got = PL.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=causal, q_chunk=qc, kv_chunk=kc)
    assert FA.LAUNCHES["flash_attention"] == 0       # the CPU: plain path
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5, atol=1e-5)


def test_flash_attention_dispatches_by_shape(monkeypatch):
    """Equal lengths on a tensor the kernel takes go to kernel 8 on
    (B·H, S, hd) with k and v repeated to H heads; unequal lengths take
    the chunked softmax; a kernel failure raises, never falls back."""
    calls = []

    def kernel(q, k, v, *, causal):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return PL._flash_chunked(
            *(t.reshape(2, 3, -1, 8).transpose(1, 2) for t in (q, k, v)),
            causal, 512, 1024).transpose(1, 2).reshape(q.shape)

    monkeypatch.setattr(PL, "_use_kernel", lambda impl, *t: True)
    monkeypatch.setattr(FA, "flash_attention_cuda", kernel)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 5, 3, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 5, 1, 8)).astype(np.float32))
    out = PL.flash_attention(q, k, k, causal=False)
    assert calls == [((6, 5, 8), (6, 5, 8), False)]
    want = PL._flash_chunked(q, PL.repeat_kv(k, 3), PL.repeat_kv(k, 3),
                             False, 512, 1024)
    assert torch.allclose(out, want, atol=1e-6)
    kx = torch.from_numpy(rng.standard_normal((2, 9, 1, 8)).astype(np.float32))
    PL.flash_attention(q, kx, kx, causal=True)
    assert len(calls) == 1

    def broken(*a, **kw):
        raise RuntimeError("flash_attention launch failed: rc 700")

    monkeypatch.setattr(FA, "flash_attention_cuda", broken)
    with pytest.raises(RuntimeError, match="rc 700"):
        PL.flash_attention(q, k, k)


def _traced_kernel(calls):
    """A stand-in for kernel 8 that records its calls and computes the
    chunked softmax on the folded (B·H, S, hd) tensors, under no_grad as
    the kernel's raw-pointer output carries no graph."""
    def kernel(q, k, v, *, causal):
        calls.append(tuple(q.shape))
        bh, s, hd = q.shape
        with torch.no_grad():
            return PL._flash_chunked(
                *(t.reshape(1, bh, s, hd).transpose(1, 2) for t in (q, k, v)),
                causal, 512, 1024).transpose(1, 2).reshape(q.shape)
    return kernel


def test_flash_attention_dispatches_by_grad_state(monkeypatch):
    """Under grad with q, k, v requiring grad the kernel is not called and
    their gradients equal the chunked path's (kernel 8 has no backward,
    and its output would carry no graph); under no_grad the kernel runs;
    the launch itself refuses a tensor that requires grad."""
    calls = []
    monkeypatch.setattr(PL, "_use_kernel", lambda impl, *t: True)
    monkeypatch.setattr(FA, "flash_attention_cuda", _traced_kernel(calls))
    rng = np.random.default_rng(1)
    arrs = [rng.standard_normal((2, 7, n, 8)).astype(np.float32)
            for n in (4, 2, 2)]

    def leaves():
        return [torch.from_numpy(a).requires_grad_(True) for a in arrs]

    q, k, v = leaves()
    out = PL.flash_attention(q, k, v, causal=True)
    assert calls == [] and out.grad_fn is not None
    w = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    q2, k2, v2 = leaves()
    ref = PL._flash_chunked(q2, PL.repeat_kv(k2, 2), PL.repeat_kv(v2, 2),
                            True, 512, 1024)
    want = torch.autograd.grad((ref * w).sum(), (q2, k2, v2))
    for g, gw in zip(got, want):
        assert torch.equal(g, gw)
    assert torch.equal(out, ref)
    with torch.no_grad():
        PL.flash_attention(q, k, v, causal=True)
    assert calls == [(8, 7, 8)]
    with pytest.raises(RuntimeError, match="no backward"):
        FA._launch(q, q, q, True, 1.0)


def test_flash_attention_wide_heads_take_the_chunked_path(monkeypatch):
    """hd 160 is wider than any built kernel body: the chunked softmax
    runs (the reference takes any hd), where the kernel would raise."""
    calls = []
    monkeypatch.setattr(PL, "_use_kernel", lambda impl, *t: True)
    monkeypatch.setattr(FA, "flash_attention_cuda", _traced_kernel(calls))
    rng = np.random.default_rng(2)
    q = rng.standard_normal((1, 5, 2, 160)).astype(np.float32)
    k = rng.standard_normal((1, 5, 1, 160)).astype(np.float32)
    with torch.no_grad():
        got = PL.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(k), causal=True)
    assert calls == []
    want = RL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                              causal=True)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5, atol=1e-5)
