"""Decode attention as one kernel a layer (``kernels/decode_attention``):
the rule that sends a decode token's RoPE, cache write and attention to
the kernel or to its plain version, the kernel's op on fake tensors, and
donation — the decode steps writing the new K / V rows into the cache
they were given and returning its leaves, and the engine donating only
the paged cache's private view.

On the CPU the kernel cannot run: the tests that follow its path stand a
plain emulation of its contract in for the launch (``_emulate``: the
plain version's new rows written into the caches it was given, in place,
one count a launch), as ``chip_smoke.py``'s rehearsals do.  The test
marked ``cuda`` holds the kernel itself against its plain version on a
card and skips without one: ``python -m pytest -m cuda
tests/test_torch_decode_attention.py``.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import sparse_model as PSM  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels.library import COSTS  # noqa: E402
from repro_torch.launch.cost_analysis import analyze_step  # noqa: E402
from repro_torch.models import factory as PF  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import engine as PE  # noqa: E402
from repro_torch.serve import faults  # noqa: E402
from repro_torch.serve.paged_cache import (ContiguousKVCache,  # noqa: E402
                                           PagedKVCache)

BF16 = torch.bfloat16
B, S = 3, 12
LENS = (0, 5, S - 1)            # the new rows: first, middle, last
PROMPT_LENS = [3, 20, 2, 28, 5, 12, 4, 9]
MAX_NEW = 4
KW = dict(batch_slots=4, max_len=48, block_size=8, prefill_chunk=8,
          policy="sjf")


def _cfg(**kw):
    """Reduced granite-3-2b at a width the kernel takes: bf16, heads of
    64, GQA 4 / 2, two layers."""
    return get_config("granite-3-2b", reduced=True).replace(
        n_layers=2, head_dim=64, param_dtype="bfloat16",
        compute_dtype="bfloat16", **kw)


@pytest.fixture(scope="module")
def model():
    cfg = _cfg()
    gen = torch.Generator().manual_seed(0)
    params = PF.init_params(cfg, gen, device="cpu")
    sparse = PSM.sparsify_model(cfg, params, 0.9, projections="all",
                                quant="int8", device="cpu")
    return cfg, params, sparse


def _emulate(monkeypatch) -> list:
    """Stand the kernel's contract in for its launch on CPU tensors; the
    returned list gets one entry a launch."""
    calls = []

    def launch(q, k, v, k_cache, v_cache, pos, theta, rope):
        out, kn, vn = DA.decode_attention_ref(q, k, v, k_cache, v_cache,
                                              pos, theta, rope)
        k_cache.copy_(kn)
        v_cache.copy_(vn)
        DA.LAUNCHES["decode_attention"] += DA.KERNELS_A_CALL
        calls.append(tuple(q.shape))
        return out

    monkeypatch.setattr(DA, "on_card", lambda *t: True)
    monkeypatch.setattr(DA, "_need_cuda", lambda *t: None)
    monkeypatch.setattr(DA, "_decode", launch)
    return calls


def _cache(cfg, seed: int = 1) -> dict:
    """A cache whose rows hold random history and whose sequences sit at
    ``LENS``."""
    cache = T.init_cache(cfg, B, S, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for n in ("k", "v"):
        cache[n] = torch.randn(cache[n].shape, generator=gen).to(BF16)
    cache["len"] = torch.tensor(LENS, dtype=torch.int32)
    return cache


def _copy(cache: dict) -> dict:
    return {n: t.clone() for n, t in cache.items()}


def _step(datapath, cfg, params, sparse):
    if datapath == "dense":
        return lambda c, b, **kw: T.decode_step(cfg, params, c, b, **kw)
    return lambda c, b, **kw: PSM.decode_step_sparse(
        cfg, params, sparse, c, b, device="cpu", **kw)


def _tokens(cfg, seed: int = 2):
    gen = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(1, cfg.vocab_size, (B, 1), generator=gen,
                                    dtype=torch.int32)}


# --------------------------------------------------------------------------
# donation through the decode steps
# --------------------------------------------------------------------------
@pytest.mark.parametrize("datapath", ["dense", "espim"])
def test_donated_step_writes_the_rows_in_place(model, datapath, monkeypatch):
    """Through the kernel's path, ``donate`` writes each layer's new row
    at ``len`` into the given cache's own leaves and returns them, with
    ``len`` a new tensor; the logits and every cache bit equal the step
    without donation (which leaves its input as it was) and the plain
    path's.  The plain path, donated or not, returns new leaves and
    leaves its input as it was."""
    cfg, params, sparse = model
    step = _step(datapath, cfg, params, sparse)
    cache, batch = _cache(cfg), _tokens(cfg)
    plain_in = _copy(cache)
    want_logits, want = step(plain_in, batch, donate=True)
    assert all(torch.equal(plain_in[n], cache[n]) for n in cache)
    assert want["k"] is not plain_in["k"]

    calls = _emulate(monkeypatch)
    kept = _copy(cache)
    logits, new = step(kept, batch)
    assert all(torch.equal(kept[n], cache[n]) for n in cache)
    assert len(calls) == cfg.n_layers
    donated = _copy(cache)
    d_logits, d_new = step(donated, batch, donate=True)
    assert len(calls) == 2 * cfg.n_layers
    assert d_new["k"] is donated["k"] and d_new["v"] is donated["v"]
    assert d_new["len"] is not donated["len"]
    assert torch.equal(d_new["len"], cache["len"] + 1)
    assert torch.equal(d_logits, logits) and torch.equal(logits, want_logits)
    for n in ("k", "v"):
        assert torch.equal(donated[n], new[n]) and torch.equal(new[n],
                                                               want[n])
        for b, p in enumerate(LENS):
            assert not torch.equal(donated[n][:, b, p], cache[n][:, b, p])
        rest = torch.ones(cache[n].shape[1:3], dtype=torch.bool)
        rest[torch.arange(B), torch.tensor(LENS)] = False
        assert torch.equal(donated[n][:, rest], cache[n][:, rest])


def test_sharded_serve_step_donates_through_the_kernel(model, monkeypatch):
    """``make_serve_step`` on a one-rank mesh passes its donated cache to
    the decode attention: the kernel's path writes the rows into the
    placed cache's own tensors, which the step returns, in the plain
    step's bits."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.serve.serve_step import make_serve_step
    from repro_torch.sharding import partition as PP
    cfg, params, _ = model
    cache, batch = _cache(cfg), _tokens(cfg)
    want, want_cache = T.decode_step(cfg, params, _copy(cache), batch)
    calls = _emulate(monkeypatch)
    mesh = make_local_mesh(device="cpu")
    sstep, sp, cs, bs = make_serve_step(cfg, mesh, params, cache, batch)
    placed = PP.logical_to_sharding(_copy(cache), cs, mesh)
    local = {n: placed[n].to_local() for n in ("k", "v")}
    _, logits, new = sstep(PP.logical_to_sharding(params, sp, mesh), placed,
                           PP.logical_to_sharding(batch, bs, mesh))
    assert len(calls) == cfg.n_layers
    assert torch.equal(logits, want)
    for n in ("k", "v"):
        assert new[n] is placed[n]
        assert torch.equal(local[n], want_cache[n])


# --------------------------------------------------------------------------
# the rule
# --------------------------------------------------------------------------
def _heads(cfg, hd=None, gen_seed=3):
    hd = hd or cfg.hd
    gen = torch.Generator().manual_seed(gen_seed)

    def r(*shape):
        return torch.randn(shape, generator=gen).to(BF16)

    return (r(B, 1, cfg.n_heads, hd), r(B, 1, cfg.n_kv_heads, hd),
            r(B, 1, cfg.n_kv_heads, hd), r(B, S, cfg.n_kv_heads, hd),
            r(B, S, cfg.n_kv_heads, hd))


@pytest.mark.parametrize("case", ["int8_cache", "mrope", "seq", "hd32",
                                  "cpu", "grad"])
def test_rule_keeps_the_plain_path(case, monkeypatch):
    """Every input the kernel does not take runs the plain version, by
    what the input shows: an int8 cache (its scales), M-RoPE positions, a
    sequence split over ranks, a head width not built, CPU tensors, an
    input that requires grad."""
    cfg = _cfg()
    q, k, v, kc, vc = _heads(cfg, 32 if case == "hd32" else None)
    lens = torch.tensor(LENS, dtype=torch.int32)
    kw, ks, vs = {}, None, None
    if case == "int8_cache":
        kc, ks = T._quantize_kv(kc)
        vc, vs = T._quantize_kv(vc)
    elif case == "mrope":
        cfg = cfg.replace(mrope=True)
        kw["positions3"] = lens[None, :, None].expand(3, B, 1)
    elif case == "seq":
        kw["seq"] = (0, lambda t: t, lambda t: t)
    elif case == "grad":
        q.requires_grad_(True)
    calls = _emulate(monkeypatch)
    if case == "cpu":
        monkeypatch.undo()
        calls = []
    T.attn_decode_core(cfg, q, k, v, kc, vc, lens, ks, vs, donate=True, **kw)
    assert calls == []
    # the same call on an input the kernel takes launches it once
    if case != "cpu":
        q, k, v, kc, vc = _heads(cfg if case != "mrope" else _cfg())
        T.attn_decode_core(_cfg(), q, k, v, kc, vc, lens, donate=True)
        assert len(calls) == 1


def test_the_pin_and_the_device_decide_where_it_runs(monkeypatch):
    """CUDA tensors (a dry run's fake ones too) run the kernel, CPU
    tensors the plain version; ``ESPIM_IMPL=ref`` pins the plain version
    everywhere."""
    monkeypatch.delenv("ESPIM_IMPL", raising=False)
    assert not DA.on_card(torch.zeros(2))
    with FakeTensorMode():
        t = torch.empty((2,), device="cuda")
        assert DA.on_card(t)
        monkeypatch.setenv("ESPIM_IMPL", "ref")
        assert not DA.on_card(t)


def test_cuda_wrapper_refuses_cpu_tensors():
    cfg = _cfg()
    q, k, v, kc, vc = _heads(cfg)
    with pytest.raises(ValueError, match="CUDA"):
        DA.decode_attention_cuda(q, k, v, kc, vc,
                                 torch.tensor(LENS, dtype=torch.int32), 1e4)


def test_splits_fill_the_card_within_the_cluster_limit():
    """A sequence's rows go to 1-8 blocks of one cluster (the source's
    ``kMaxSplits``), the most that keep the grid within what the SMs hold
    at once: 2 at the served cells' B 32 x KV 8 on an H100's 132 SMs, 8
    at B 1."""
    from repro_torch.kernels import build
    src = build.SOURCES["decode_attention"].read_text()
    assert int(re.search(r"constexpr int kMaxSplits = (\d+);", src)[1]) \
        == DA.MAX_SPLITS
    assert DA.splits(32, 8, 132) == 2 and DA.splits(1, 8, 132) == 8
    for b in (1, 2, 3, 7, 16, 32, 64, 512):
        for kvh in (1, 2, 8, 32):
            n = DA.splits(b, kvh, 132)
            assert 1 <= n <= DA.MAX_SPLITS and n & (n - 1) == 0
            assert n == 1 or b * kvh * n <= DA.BLOCKS_AN_SM * 132
            assert n == DA.MAX_SPLITS or b * kvh * 2 * n \
                > DA.BLOCKS_AN_SM * 132


# --------------------------------------------------------------------------
# the op on fake tensors
# --------------------------------------------------------------------------
@pytest.mark.parametrize("donate", [False, True])
def test_op_traces_on_fake_cuda_tensors(donate):
    """On fake ``cuda`` tensors the op's Meta kernel gives the output's
    shape and dtype, and nothing launches or counts."""
    before = dict(DA.LAUNCHES)
    b, s, h, kvh, hd = 4, 96, 8, 2, 128
    with FakeTensorMode():
        q = torch.empty((b, 1, h, hd), dtype=BF16, device="cuda")
        k = torch.empty((b, 1, kvh, hd), dtype=BF16, device="cuda")
        kc = torch.empty((b, s, kvh, hd), dtype=BF16, device="cuda")
        pos = torch.empty((b,), dtype=torch.int32, device="cuda")
        out, k2, v2 = DA.decode_attention(q, k, k, kc, kc.clone(), pos, 1e4,
                                          donate=donate)
        assert out.device.type == "cuda"
    assert tuple(out.shape) == (b, 1, h, hd) and out.dtype == BF16
    assert (k2 is kc) == donate
    assert tuple(k2.shape) == tuple(v2.shape) == (b, s, kvh, hd)
    assert DA.LAUNCHES == before


def test_op_cost_is_every_cache_row_once():
    """The cost analysis reads 4 B H hd operations a cache row (the
    masked rows included, as the plain version computes them) and every
    operand's bytes once, the output's once."""
    b, s, h, kvh, hd = 4, 96, 8, 2, 64
    shapes = [((b, 1, h, hd), BF16), ((b, 1, kvh, hd), BF16),
              ((b, 1, kvh, hd), BF16), ((b, s, kvh, hd), BF16),
              ((b, s, kvh, hd), BF16), ((b,), torch.int32)]
    with FakeTensorMode():
        ts = [torch.empty(sh, dtype=d, device="cuda") for sh, d in shapes]
        cost = analyze_step(
            lambda *a: DA.decode_attention_cuda(*a, 1e4), *ts)
    assert "decode_attention" in COSTS
    assert cost.dot_flops == 4 * b * h * hd * s
    assert cost.dot_bytes == 2 * (2 * b * h * hd + 2 * b * kvh * hd
                                  + 2 * b * s * kvh * hd) + 4 * b


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------
def _trace(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(1, vocab, n).tolist() for n in PROMPT_LENS]


def _serve(eng, trace, on_step=None):
    reqs = [PE.Request(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(trace)]
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.scheduler.has_pending or any(s is not None for s in eng.slots):
        eng.step()
        steps += 1
        if on_step is not None:
            on_step(eng, steps)
    return [r.output for r in reqs], eng.stats


def _spy_donate(monkeypatch) -> list:
    """Record the ``donate`` of every decode attention call."""
    seen, inner = [], DA.decode_attention

    def spy(*args, donate=False, **kw):
        seen.append(donate)
        return inner(*args, donate=donate, **kw)

    monkeypatch.setattr(DA, "decode_attention", spy)
    return seen


@pytest.mark.parametrize("quant", [None, "int8"])
def test_engine_paged_donates_contiguous_never(model, quant, monkeypatch):
    """Through the kernel's path, the paged engine donates its private
    view and the contiguous one never donates its store; both give the
    greedy tokens of the plain path, and the arena ends clean."""
    cfg, params, sparse = model
    sparse = sparse if quant else None
    trace = _trace(cfg.vocab_size)
    want, _ = _serve(PE.ServeEngine(cfg, params, sparse=sparse,
                                    device="cpu", **KW), trace)
    calls = _emulate(monkeypatch)
    seen = _spy_donate(monkeypatch)
    outs = {}
    for paged in (True, False):
        eng = PE.ServeEngine(cfg, params, sparse=sparse, device="cpu",
                             paged=paged, **KW)
        assert eng.cache.view_is_private == paged
        seen.clear()
        outs[paged], st = _serve(eng, trace)
        assert st.requests_completed == len(trace)
        assert seen and set(seen) == {paged}
        eng.check_arena()
    assert calls
    assert outs[True] == outs[False] == want
    assert PagedKVCache.view_is_private
    assert not ContiguousKVCache.view_is_private


def _poison_first_value(sparse):
    """A copy of the packs whose first group's first bucket has a NaN row
    scale: every step over it gives some slot non-finite logits."""
    out = dict(sparse)
    out["groups"] = {n: dict(g, buckets=[dict(b) for b in g["buckets"]])
                     for n, g in sparse["groups"].items()}
    out.update(out["groups"])
    b = out["groups"][next(iter(out["groups"]))]["buckets"][0]
    srow = b["srow"].clone()
    srow[0] = float("nan")
    b["srow"] = srow
    return out


def test_quarantine_drill_parity_with_donation(model, monkeypatch):
    """The fault ladder with the donated view: packs poisoned from tick 5
    quarantine slots to the dense fallback, whose closure shares the
    ticks (and the donated view) with the healthy one; every request
    finishes with the tokens of the no-fault run, as on the plain path."""
    cfg, params, sparse = model
    trace = _trace(cfg.vocab_size)
    bad = _poison_first_value(sparse)

    def poison(e, step):
        if step == 5:
            faults.inject_poisoned_decode(e, bad)

    def serve(faulty):
        eng = PE.ServeEngine(cfg, params, sparse=sparse, device="cpu", **KW)
        ticks, launch = [], eng._launch

        def spy(fn, p, view, batch, span):
            ticks.append((eng.stats.steps, span))
            return launch(fn, p, view, batch, span)

        eng._launch = spy
        out, st = _serve(eng, trace, poison if faulty else None)
        eng.check_arena()
        return out, st, ticks

    plain, plain_st, _ = serve(True)
    calls = _emulate(monkeypatch)
    base, _, _ = serve(False)
    got, st, ticks = serve(True)
    assert calls
    assert got == base == plain
    assert st.quarantines >= 1 and st.degraded_tokens >= 1
    assert st.requests_failed == 0
    assert st.requests_completed == len(trace)
    assert (st.quarantines, st.degraded_tokens) == (plain_st.quarantines,
                                                    plain_st.degraded_tokens)
    both = {t for t, s in ticks if s == "decode.launch"} & {
        t for t, s in ticks if s == "decode.launch_degraded"}
    assert both, "no tick ran the healthy and the degraded closure"


# --------------------------------------------------------------------------
# the kernel on the card
# --------------------------------------------------------------------------
# |kernel - plain| <= OUT_REL |plain| + OUT_ABS max|plain| elementwise:
# each side rounds its float32 result to bf16 once (up to one bf16 step,
# 2^-8 of the value, each), and the two sum the scores and P.V in float32
# in different orders, the kernel with base-2 exponentials
OUT_REL, OUT_ABS = 2.0 ** -7, 2.0 ** -10
CARD_S = 1536
CARD_LENS = {"zero": [0], "one": [1], "edge": [191], "edge2": [192],
             "last": [CARD_S - 1]}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


def _card_lens(b: int, which: str, gen) -> torch.Tensor:
    if which == "mix":
        edges = [0, 1, 7, 8, 9, 191, 192, 193, CARD_S - 2, CARD_S - 1]
        rest = torch.randint(0, CARD_S, (b,), generator=gen).tolist()
        return torch.tensor((edges + rest)[:b], dtype=torch.int32)
    if which == "random":
        return torch.randint(0, CARD_S, (b,), generator=gen,
                             dtype=torch.int32)
    return torch.tensor(CARD_LENS[which] * b, dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("heads", [(32, 8), (8, 8)])
@pytest.mark.parametrize("b,which", [(32, "mix"), (1, "zero"), (1, "one"),
                                     (1, "edge"), (1, "edge2"),
                                     (1, "random"), (1, "last")])
def test_kernel_matches_its_plain_version(card, hd, heads, b, which):
    """The kernel against the plain version on the card, bf16, S 1536:
    the caches after the launch (the written rows and every other) in
    the plain version's bits, the output within ``OUT_REL`` / ``OUT_ABS``
    and in the same bits on a second launch, one count a launch."""
    h, kvh = heads
    gen = torch.Generator().manual_seed(1000 * hd + 10 * h + b)
    lens = _card_lens(b, which, gen).to(card)

    def r(*shape):
        return torch.randn(shape, generator=gen).to(BF16).to(card)

    q, k, v = r(b, 1, h, hd), r(b, 1, kvh, hd), r(b, 1, kvh, hd)
    kc, vc = r(b, CARD_S, kvh, hd), r(b, CARD_S, kvh, hd)
    want, wk, wv = DA.decode_attention_ref(q, k, v, kc, vc, lens, 1e4, True)
    DA.reset_launches()
    got = []
    for _ in range(2):
        gk, gv = kc.clone(), vc.clone()
        got.append(DA.decode_attention_cuda(q, k, v, gk, gv, lens, 1e4))
        torch.cuda.synchronize()
        assert torch.equal(gk, wk) and torch.equal(gv, wv)
    assert DA.LAUNCHES["decode_attention"] == 2 * DA.KERNELS_A_CALL
    assert torch.equal(got[0], got[1])
    diff = (got[0].float() - want.float()).abs()
    bound = OUT_REL * want.float().abs() + OUT_ABS * want.float().abs().max()
    assert bool((diff <= bound).all()), float(diff.max())


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["new_k", "new_v", "old_k", "old_v"])
@pytest.mark.parametrize("pos", [1, 700])
def test_kernel_passes_a_nonfinite_row_to_the_output(card, where, pos):
    """A NaN in the new row or in a live row of the cache reaches the
    output of every q head of its KV head, as in the plain version's
    softmax, also where that row is alone in its block (the engine's
    finite check on the logits depends on it), and no other head's."""
    b, h, kvh, hd, s = 1, 32, 8, 64, CARD_S
    gen = torch.Generator().manual_seed(7)

    def r(*shape):
        return torch.randn(shape, generator=gen).to(BF16).to(card)

    q, k, v = r(b, 1, h, hd), r(b, 1, kvh, hd), r(b, 1, kvh, hd)
    kc, vc = r(b, s, kvh, hd), r(b, s, kvh, hd)
    t, row = {"new_k": (k, 0), "new_v": (v, 0), "old_k": (kc, pos - 1),
              "old_v": (vc, pos - 1)}[where]
    t[0, row, 3, 5] = float("nan")
    lens = torch.tensor([pos], dtype=torch.int32, device=card)
    want, _, _ = DA.decode_attention_ref(q, k, v, kc, vc, lens, 1e4, True)
    got = DA.decode_attention_cuda(q, k, v, kc.clone(), vc.clone(), lens,
                                   1e4)
    torch.cuda.synchronize()
    nan_heads = got.isnan().any(dim=-1)[0, 0]
    assert torch.equal(nan_heads, want.isnan().any(dim=-1)[0, 0])
    assert nan_heads.tolist() == [i // (h // kvh) == 3 for i in range(h)]
