"""The port's ServeEngine against the JAX package's: the same 8-request
trace gives the same greedy tokens (fp and int8 packs), and inside the
port the paged cache is bit-identical to the contiguous one."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import sparse_model as RSM  # noqa: E402
from repro.serve import engine as RE  # noqa: E402

from _torch_parity import smoke_model  # noqa: E402
from repro_torch.core import sparse_model as PSM  # noqa: E402
from repro_torch.serve import engine as PE  # noqa: E402

PROMPT_LENS = [3, 20, 2, 28, 5, 12, 4, 9]
MAX_NEW = 4
KW = dict(batch_slots=4, max_len=48, block_size=8, prefill_chunk=8,
          policy="sjf")


def _trace(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(1, vocab, n).tolist() for n in PROMPT_LENS]


def _serve(mod, eng, trace):
    reqs = [mod.Request(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(trace)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    return [r.output for r in reqs], stats


@pytest.fixture(scope="module")
def model():
    return smoke_model(n_layers=2)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_greedy_tokens_equal_reference(model, quant):
    cfg, pcfg, params, tparams = model
    trace = _trace(cfg.vocab_size)
    rs = RSM.sparsify_model(cfg, params, 0.9, quant=quant)
    ps = PSM.sparsify_model(pcfg, tparams, 0.9, quant=quant, device="cpu")
    want, _ = _serve(RE, RE.ServeEngine(cfg, params, sparse=rs, impl="ref",
                                        **KW), trace)
    eng = PE.ServeEngine(pcfg, tparams, sparse=ps, device="cpu", **KW)
    got, stats = _serve(PE, eng, trace)
    assert got == want
    assert stats.requests_completed == len(trace)
    assert stats.tokens_generated == len(trace) * MAX_NEW
    assert eng.check_arena()["allocated"] == 0
    assert eng.cache.free_blocks == eng.cache.num_blocks
    lat = stats.latency_summary()
    assert lat["states"] == {"completed": len(trace)}


def test_paged_bit_identical_to_contiguous(model):
    _, pcfg, _, tparams = model
    trace = _trace(pcfg.vocab_size)
    ps = PSM.sparsify_model(pcfg, tparams, 0.9, quant="int8", device="cpu")
    outs = []
    for paged in (True, False):
        eng = PE.ServeEngine(pcfg, tparams, sparse=ps, device="cpu",
                             paged=paged, **KW)
        outs.append(_serve(PE, eng, trace)[0])
    assert outs[0] == outs[1]


def test_non_finite_slot_is_torn_down_as_failed(model):
    _, pcfg, _, tparams = model
    ps = PSM.sparsify_model(pcfg, tparams, 0.9, device="cpu")
    eng = PE.ServeEngine(pcfg, tparams, sparse=ps, device="cpu", **KW)
    bad = dict(tparams)
    bad["embed"] = tparams["embed"].clone()
    bad["embed"][7] = float("nan")           # token 7 poisons its slot
    eng.params = bad
    reqs = [PE.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=MAX_NEW),
            PE.Request(rid=1, prompt=[7, 7], max_new_tokens=MAX_NEW)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    assert stats.requests_failed == 1 and stats.requests_completed == 1
    assert len(reqs[0].output) == MAX_NEW and reqs[1].output == []
    assert eng.cache.free_blocks == eng.cache.num_blocks


def test_submit_rejects_infeasible_requests(model):
    _, pcfg, _, tparams = model
    ps = PSM.sparsify_model(pcfg, tparams, 0.9, device="cpu")
    eng = PE.ServeEngine(pcfg, tparams, sparse=ps, device="cpu", **KW)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(PE.Request(rid=0, prompt=[1] * 48))
    with pytest.raises(ValueError, match="unknown model family"):
        PE.ServeEngine(pcfg.replace(family="bogus"), tparams, device="cpu",
                       **KW)
