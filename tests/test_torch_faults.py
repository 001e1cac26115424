"""The port's fault drill and fault injectors against the JAX package's,
and token-replay prefill.

``run_fault_drill`` runs all eight fault kinds through the port
(``device="cpu"``, plain versions) and the reference (``impl="ref"``) on
the same smoke model and seed, once with fp packs as ``sparse`` and int8
packs as ``sparse_alt``, and once with int8 packs as ``sparse`` (the
card's case).  Tolerance: each kind's load rejection, terminal states,
token and quarantine / retry counts, leaked blocks and unaffected parity
equal the reference's, and ``check_drill`` passes unchanged.  The
watchdog reads the wall clock, so only the spike's ``watchdog_flags > 0``
is compared.  Every injector leaves the packs it was given as they were:
torch tensors are shared by a structural copy, so a corrupted plane must
be a new tensor."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import sparse_model as RSM  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.serve import faults as RF  # noqa: E402

from _torch_parity import drain, smoke_model  # noqa: E402
from repro_torch.core import sparse_model as PSM  # noqa: E402
from repro_torch.core.integrity import PackIntegrityError  # noqa: E402
from repro_torch.serve import engine as PE  # noqa: E402
from repro_torch.serve import faults as PF  # noqa: E402

DRILL_KEYS = ("rejected_at_load", "states", "tokens", "degraded_tokens",
              "quarantines", "retries", "leaked_blocks", "unaffected_parity",
              "affected_rids")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The latency-spike drill's watchdog reads the wall clock.  With
    several test workers on one host, torch's intra-op thread pool
    oversubscribes the cores and a smoke-size decode step slows toward the
    spike itself; one thread keeps the step near its solo time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg, pcfg, params, tparams = smoke_model(n_layers=2)
    ref = {q: RSM.sparsify_model(cfg, params, 0.9, quant=q)
           for q in (None, "int8")}
    port = {q: PSM.sparsify_model(pcfg, tparams, 0.9, quant=q, device="cpu")
            for q in (None, "int8", "int4")}
    return cfg, pcfg, params, tparams, ref, port


def test_fault_kinds_match_reference():
    assert PF.FAULT_KINDS == RF.FAULT_KINDS
    assert PF.LOAD_FAULTS == RF.LOAD_FAULTS
    assert len(PF.FAULT_KINDS) == 8


@pytest.mark.parametrize("case", ["fp+int8_alt", "int8"])
def test_fault_drill_matches_reference(model, case):
    cfg, pcfg, params, tparams, ref, port = model
    if case == "int8":
        rargs, pargs = (ref["int8"], None), (port["int8"], None)
    else:
        rargs, pargs = (ref[None], ref["int8"]), (port[None], port["int8"])
    want = RF.run_fault_drill(cfg, params, *rargs, seed=0)
    got = PF.run_fault_drill(pcfg, tparams, *pargs, seed=0, device="cpu")
    PF.check_drill(got)
    RF.check_drill(got)
    assert set(got["faults"]) == set(PF.FAULT_KINDS)
    assert got["baseline"]["tokens"] == want["baseline"]["tokens"]
    for kind in PF.FAULT_KINDS:
        g, w = got["faults"][kind], want["faults"][kind]
        assert {k: g.get(k) for k in DRILL_KEYS} == \
            {k: w.get(k) for k in DRILL_KEYS}, kind
    for kind in PF.LOAD_FAULTS:
        assert got["faults"][kind]["rejected_at_load"]
    for kind in set(PF.FAULT_KINDS) - set(PF.LOAD_FAULTS):
        g = got["faults"][kind]
        assert g["tokens_equal_baseline"] == g["tokens_compared"] > 0
    assert got["faults"]["latency_spike"]["watchdog_flags"] > 0
    assert want["faults"]["latency_spike"]["watchdog_flags"] > 0
    assert got["faults"]["transient_step_error"]["retries"] >= 1
    assert got["faults"]["nonfinite_logits"]["quarantines"] >= 1
    assert got["faults"]["abort_mid_decode"]["states"]["cancelled"] == 1


def _fingerprints(sparse):
    return {name: PSM._group_fingerprint(g)[1]
            for name, g in sparse["groups"].items()}


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_injectors_leave_the_given_packs_intact(model, quant):
    _, _, _, _, _, port = model
    sparse = port[quant]
    before = _fingerprints(sparse)
    assert before == {n: g["fingerprint"]
                      for n, g in sparse["groups"].items()}
    rng = np.random.default_rng(0)
    bad = [PF.corrupt_group_plane(sparse, "index", rng),
           PF.corrupt_group_plane(sparse, "value", rng),
           PF.mismatch_schedule(sparse),
           PF.poison_values(sparse, rng)]
    assert _fingerprints(sparse) == before
    PSM.verify_sparse(sparse)                 # the original still verifies
    for b in bad[:3]:
        with pytest.raises(PackIntegrityError):
            PSM.verify_sparse(b)
        assert b["groups"]["qkv"] is b["qkv"]  # aliases re-pointed
    # the poisoned copy changed exactly one plane of one bucket
    g0, p0 = sparse["groups"]["qkv"], bad[3]["groups"]["qkv"]
    key = "values" if "values" in g0["buckets"][0] else "srow"
    assert not torch.equal(p0["buckets"][0][key], g0["buckets"][0][key])
    assert int(torch.isnan(p0["buckets"][0][key]).sum()) == 1
    assert p0["buckets"][0][key].dtype == g0["buckets"][0][key].dtype
    assert p0["buckets"][0]["cols"] is g0["buckets"][0]["cols"]


def test_flip_bit_matches_the_reference_bit(model):
    _, _, _, _, ref, port = model
    want = RF.flip_bit(np.asarray(ref[None]["qkv"]["buckets"][0]["cols"]),
                       np.random.default_rng(4))
    plane = port[None]["qkv"]["buckets"][0]["cols"]
    got = PF.flip_bit(plane, np.random.default_rng(4))
    assert got.dtype == plane.dtype and got.device == plane.device
    assert np.array_equal(got.numpy(), want)
    assert not torch.equal(got, plane)


# --------------------------------------------------------------------------
# token-replay prefill
# --------------------------------------------------------------------------
PROMPT_LENS = [3, 20, 2, 12]


def _replay_run(mod, eng, vocab):
    rng = np.random.default_rng(11)
    reqs = [mod.Request(rid=i, prompt=rng.integers(1, vocab, n).tolist(),
                        max_new_tokens=4)
            for i, n in enumerate(PROMPT_LENS)]
    drain(eng, reqs)
    return [r.output for r in reqs], eng.stats


def test_replay_prefill_matches_reference_and_chunked(model):
    cfg, pcfg, params, tparams, ref, port = model
    kw = dict(batch_slots=4, max_len=48, block_size=8, prefill_chunk=8)
    want, _ = _replay_run(RE, RE.ServeEngine(
        cfg, params, sparse=ref["int8"], prefill_mode="replay", **kw),
        cfg.vocab_size)
    eng = PE.ServeEngine(pcfg, tparams, sparse=port["int8"],
                         prefill_mode="replay", device="cpu",
                         validate_arena=True, **kw)
    assert not eng.chunked_prefill and eng._prefiller is None
    got, stats = _replay_run(PE, eng, pcfg.vocab_size)
    chunked, cstats = _replay_run(PE, PE.ServeEngine(
        pcfg, tparams, sparse=port["int8"], device="cpu", **kw),
        pcfg.vocab_size)
    assert got == want == chunked
    assert stats.prefill_chunks == 0 and cstats.prefill_chunks > 0
    # every prompt token but the last went through the decode step
    assert stats.decode_steps >= max(PROMPT_LENS) - 1 + 4
    assert stats.latency_summary()["states"] == {"completed": 4}
    assert eng.cache.free_blocks == eng.cache.num_blocks


def test_auto_prefill_mode_picks_chunked_for_the_dense_family(model):
    _, pcfg, _, tparams, _, port = model
    kw = dict(batch_slots=2, max_len=32, device="cpu")
    assert PE.ServeEngine(pcfg, tparams, sparse=port[None],
                          **kw).chunked_prefill
    assert PE.ServeEngine(pcfg, tparams, **kw).chunked_prefill
    assert PE.ServeEngine(pcfg, tparams, prefill_mode="chunked",
                          **kw).chunked_prefill
