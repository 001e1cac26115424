"""The port's ``ServeEngine(sparse=None)`` serving the other model
families against the JAX package's engine, at the reduced configs in
float32: greedy tokens equal the reference's (moe, vlm and audio
prefill by token replay, ssm and hybrid by chunks); the paged cache
gives the contiguous one's tokens and logits bit for bit for the
families with per-slot recurrent state; a preempted run gives the
never-preempted run's tokens; ``snapshot`` / ``restore`` resumes an
rwkv engine with every token equal; and the launcher serves each
family's reduced arch on the CPU."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import get_config as ref_config  # noqa: E402
from repro.models import factory as RF  # noqa: E402
from repro.serve import engine as RE  # noqa: E402

from _torch_parity import drain  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.serve import engine as PE  # noqa: E402

FAMILY_ARCHS = {"moe": "phi3.5-moe-42b-a6.6b", "vlm": "qwen2-vl-2b",
                "audio": "whisper-small", "ssm": "rwkv6-1.6b",
                "hybrid": "zamba2-2.7b"}
RECURRENT = ["rwkv6-1.6b", "zamba2-2.7b", "whisper-small"]
KW = dict(batch_slots=4, max_len=40, block_size=8, prefill_chunk=8,
          policy="sjf")
PROMPT_LENS = [3, 11, 2, 17, 5, 9]
MAX_NEW = 5


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    cfg = ref_config(arch, reduced=True)
    pcfg = get_config(arch, reduced=True)
    params = RF.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return cfg, pcfg, params, tparams


def _trace(vocab, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in PROMPT_LENS]


def _serve(mod, eng, trace, max_new=MAX_NEW):
    reqs = [mod.Request(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(trace)]
    drain(eng, reqs)
    return [r.output for r in reqs]


def _port(arch, **kw):
    _, pcfg, _, tparams = _model(arch)
    return PE.ServeEngine(pcfg, tparams, device="cpu",
                          validate_arena=True, **{**KW, **kw})


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_engine_matches_reference_greedy(family):
    arch = FAMILY_ARCHS[family]
    cfg, _, params, _ = _model(arch)
    trace = _trace(cfg.vocab_size)
    want = _serve(RE, RE.ServeEngine(cfg, params, **KW), trace)
    eng = _port(arch)
    assert eng.chunked_prefill == (family in ("ssm", "hybrid"))
    got = _serve(PE, eng, trace)
    assert got == want
    assert all(len(o) == MAX_NEW for o in got)
    assert eng.stats.requests_completed == len(trace)
    assert eng.cache.free_blocks == eng.cache.num_blocks


@pytest.mark.parametrize("arch", RECURRENT)
def test_paged_equals_contiguous_bits(arch, monkeypatch):
    """Every decode tick's logits and every token, paged against
    contiguous; the state leaves end zeroed in both."""
    cfg = _model(arch)[0]
    trace = _trace(cfg.vocab_size, seed=4)
    real = PE.serve_step_fn
    runs = {}
    for paged in (True, False):
        logits = []

        def step(*a, _log=logits, **kw):
            nxt, lg, cache = real(*a, **kw)
            _log.append(lg.clone())
            return nxt, lg, cache

        monkeypatch.setattr(PE, "serve_step_fn", step)
        eng = _port(arch, paged=paged)
        assert eng.cache.state_names
        runs[paged] = (_serve(PE, eng, trace), logits)
        for leaf in eng.cache.state.values():
            assert not bool(leaf.any())
    (tok_p, lg_p), (tok_c, lg_c) = runs[True], runs[False]
    assert tok_p == tok_c
    assert len(lg_p) == len(lg_c) > 0
    assert all(torch.equal(a, b) for a, b in zip(lg_p, lg_c))


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_replay_prefill_gives_the_chunked_tokens(arch):
    """Token replay builds the recurrent state in the slot itself, so a
    reused slot must start from the zeros its last request left."""
    cfg = _model(arch)[0]
    trace = _trace(cfg.vocab_size, seed=6)
    want = _serve(PE, _port(arch), trace)
    eng = _port(arch, prefill_mode="replay")
    assert not eng.chunked_prefill
    assert _serve(PE, eng, trace) == want


def _preempt_run(arch, tight: bool):
    """A long request, then a short one into an arena of the long one's
    worst case: the long one is preempted and later resumes."""
    _, pcfg, _, tparams = _model(arch)
    rng = np.random.default_rng(7)
    long_p = rng.integers(1, pcfg.vocab_size, 6).tolist()
    short_p = rng.integers(1, pcfg.vocab_size, 4).tolist()
    kw = dict(batch_slots=2, max_len=48, block_size=8, prefill_chunk=8,
              device="cpu")
    long_r = PE.Request(rid=0, prompt=long_p, max_new_tokens=14)
    if tight:
        probe = PE.ServeEngine(pcfg, tparams, **kw)
        kw["num_blocks"] = probe.cache.blocks_needed(
            long_r.worst_case_tokens(48))
    eng = PE.ServeEngine(pcfg, tparams, **kw)
    short_r = PE.Request(rid=1, prompt=short_p, max_new_tokens=3)
    eng.submit(long_r)
    for _ in range(3):
        eng.step()
    eng.submit(short_r)
    drain(eng, [])
    eng.check_arena()
    return eng, [long_r.output, short_r.output]


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_preemption_gives_the_uninterrupted_tokens(arch):
    base, want = _preempt_run(arch, tight=False)
    eng, got = _preempt_run(arch, tight=True)
    assert base.stats.preempts == 0 and eng.stats.preempts >= 1
    assert got == want
    assert [len(o) for o in got] == [14, 3]


def test_snapshot_restore_resumes_rwkv():
    arch = "rwkv6-1.6b"
    cfg = _model(arch)[0]
    trace = _trace(cfg.vocab_size, seed=5)
    want = _serve(PE, _port(arch), trace)
    eng = _port(arch)
    reqs = [PE.Request(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(trace)]
    for r in reqs:
        eng.submit(r)
    for _ in range(9):                   # mid-prefill and mid-decode slots
        eng.step()
    assert any(s is not None and s.phase == "decode" for s in eng.slots)
    snap = eng.snapshot()
    fresh = _port(arch)
    restored = fresh.restore(snap, {r.rid: r for r in reqs})
    assert restored and all(any(r is q for q in reqs) for r in restored)
    drain(fresh, [])
    assert [r.output for r in reqs] == want


@pytest.mark.parametrize("arch", sorted(FAMILY_ARCHS.values()))
def test_launcher_serves_each_family(arch, capsys):
    stats = launch_serve.main(["--arch", arch, "--reduced", "--requests",
                               "3", "--max-new-tokens", "4",
                               "--device", "cpu"])
    assert stats.requests_completed == 3
    assert stats.tokens_generated == 12
    assert capsys.readouterr().out.startswith("completed 3 requests, 12 ")
