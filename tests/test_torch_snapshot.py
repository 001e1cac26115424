"""The port's snapshot/restore against the JAX package's: the crash drill
(kill at a step boundary, snapshot through JSON, restore into a fresh
engine) for fp, int8 and int4 packs and the dense engine, random kill
steps, the snapshot's schema and rejections, reattached requests and
the shed bypass.

Tolerance: a restored run's greedy tokens equal the uninterrupted run's
bit for bit inside the port, and the reference's crash drill on the same
model and seed; ``check_crash_drill`` passes unchanged.  The snapshot's
``pack_fingerprint`` equals the reference engine's on the same packs."""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import sparse_model as RSM  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.serve import faults as RF  # noqa: E402
from repro.serve import snapshot as rsnap  # noqa: E402

from _torch_parity import smoke_model  # noqa: E402
from repro_torch.core import sparse_model as PSM  # noqa: E402
from repro_torch.core.integrity import PackIntegrityError  # noqa: E402
from repro_torch.serve import faults as PF  # noqa: E402
from repro_torch.serve import snapshot as snapmod  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.snapshot import (SNAPSHOT_VERSION,  # noqa: E402
                                        SnapshotIntegrityError)

QUANTS = ("fp", "int8", "int4")
# a control-plane snapshot carries no KV planes; the generator state it
# also holds is a fixed size (5056 bytes for a CPU generator)
SNAPSHOT_BYTES_MAX = 16_384


@pytest.fixture(scope="module")
def model():
    return smoke_model(n_layers=2)


@pytest.fixture(scope="module")
def packs(model):
    _, pcfg, _, tparams = model
    return {q: PSM.sparsify_model(pcfg, tparams, 0.9, row_tile=32,
                                  quant=None if q == "fp" else q,
                                  device="cpu")
            for q in QUANTS}


def _eng(model, sparse, **kw):
    _, pcfg, _, tparams = model
    kw.setdefault("max_len", 48)
    return ServeEngine(pcfg, tparams, batch_slots=2, sparse=sparse,
                       block_size=8, prefill_chunk=8, validate_arena=True,
                       device="cpu", **kw)


def _reqs(n=3, seed=3):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(1, 400, 4 + 2 * i).tolist(),
                    max_new_tokens=5) for i in range(n)]


def _control_plane_bytes(drill_snap_text: str) -> int:
    doc = json.loads(drill_snap_text)
    return len(drill_snap_text) - len(json.dumps(doc["rng_key"]))


@pytest.mark.parametrize("quant", QUANTS)
def test_crash_drill_round_trip_parity(model, packs, quant):
    cfg, pcfg, params, tparams = model
    drill = PF.run_crash_drill(pcfg, tparams, packs[quant], seed=1,
                               n_requests=3, max_new_tokens=5, kill_step=7,
                               device="cpu")
    PF.check_crash_drill(drill)
    assert drill["exact_parity"] and drill["leaked_blocks"] == 0
    assert drill["restored_requests"] >= 1
    assert drill["states"] == {"completed": drill["restored_requests"]}
    assert drill["tokens_after_kill_equal"] == drill["tokens_after_kill"] > 0
    ref = RF.run_crash_drill(cfg, params, RSM.sparsify_model(
        cfg, params, 0.9, row_tile=32, quant=None if quant == "fp" else quant),
        seed=1, n_requests=3, max_new_tokens=5, kill_step=7)
    for k in ("kill_step", "total_steps", "in_flight_at_kill",
              "restored_requests", "parity", "states", "leaked_blocks"):
        assert drill[k] == ref[k], k


def test_crash_drill_dense_engine(model):
    _, pcfg, _, tparams = model
    drill = PF.run_crash_drill(pcfg, tparams, None, seed=2, n_requests=2,
                               max_new_tokens=4, device="cpu")
    PF.check_crash_drill(drill)
    RF.check_crash_drill(drill)


def test_crash_drill_random_kill_steps(model, packs):
    _, pcfg, _, tparams = model
    kw = dict(seed=0, n_requests=2, max_new_tokens=4, device="cpu")
    base = PF.run_crash_drill(pcfg, tparams, packs["fp"], kill_step=1, **kw)
    for frac in (0.5, 0.9):
        k = max(1, int(base["total_steps"] * frac))
        PF.check_crash_drill(PF.run_crash_drill(pcfg, tparams, packs["fp"],
                                                kill_step=k, **kw))
    PF.check_crash_drill(base)


def test_snapshot_schema_and_json_round_trip(model, packs):
    cfg, _, params, _ = model
    eng = _eng(model, packs["fp"])
    for r in _reqs():
        eng.submit(r)
    for _ in range(5):
        eng.step()
    snap = eng.snapshot()
    assert snap["version"] == SNAPSHOT_VERSION
    assert snap["pack_fingerprint"] == packs["fp"]["fingerprint"]
    # the same packs bind the same fingerprint in the reference's engine
    ref_eng = RE.ServeEngine(cfg, params, 2, 48, sparse=RSM.sparsify_model(
        cfg, params, 0.9, row_tile=32), block_size=8, prefill_chunk=8)
    assert rsnap._engine_fingerprint(ref_eng) == snap["pack_fingerprint"]
    assert snap["digest"] == snapmod.snapshot_digest(snap)
    assert set(snap) == {"version", "model", "max_len", "temperature",
                         "pack_fingerprint", "rng_key", "geometry",
                         "block_tables", "requests", "stats", "digest"}
    assert snap["rng_key"] == eng._gen.get_state().tolist()
    origins = [e["origin"] for e in snap["requests"]]
    assert set(origins) <= {"slot", "queue"}
    assert origins == sorted(origins, key=lambda o: o != "slot")
    text = snapmod.dumps(snap)
    assert _control_plane_bytes(text) < SNAPSHOT_BYTES_MAX
    assert snapmod.loads(text) == snap


def test_restore_sets_the_generator_state(model, packs):
    eng = _eng(model, packs["fp"], temperature=0.7, seed=5)
    for r in _reqs(2):
        eng.submit(r)
    for _ in range(4):
        eng.step()
    snap = eng.snapshot()
    fresh = _eng(model, packs["fp"], temperature=0.7, seed=9)
    assert not torch.equal(fresh._gen.get_state(), eng._gen.get_state())
    fresh.restore(snap)
    assert torch.equal(fresh._gen.get_state(), eng._gen.get_state())


def test_restore_rejects_fingerprint_mismatch(model, packs):
    eng = _eng(model, packs["fp"])
    eng.submit(_reqs(1)[0])
    eng.step()
    snap = eng.snapshot()
    with pytest.raises(SnapshotIntegrityError, match="different weights"):
        _eng(model, packs["int8"]).restore(snap)
    with pytest.raises(SnapshotIntegrityError):
        _eng(model, None).restore(snap)
    assert issubclass(SnapshotIntegrityError, PackIntegrityError)


def test_restore_rejects_tamper_version_and_busy_engine(model, packs):
    eng = _eng(model, packs["fp"])
    for r in _reqs(2):
        eng.submit(r)
    for _ in range(4):
        eng.step()
    snap = eng.snapshot()

    tampered = dict(snap)
    tampered["requests"] = [dict(e) for e in snap["requests"]]
    tampered["requests"][0]["output"] = \
        list(tampered["requests"][0]["output"]) + [7]
    with pytest.raises(SnapshotIntegrityError, match="digest"):
        snapmod.validate_snapshot(tampered)

    wrong_version = dict(snap, version=SNAPSHOT_VERSION + 1)
    wrong_version["digest"] = snapmod.snapshot_digest(wrong_version)
    with pytest.raises(SnapshotIntegrityError, match="version"):
        snapmod.validate_snapshot(wrong_version)

    fresh = _eng(model, packs["fp"], max_len=eng.max_len * 2)
    with pytest.raises(SnapshotIntegrityError, match="max_len"):
        fresh.restore(snap)
    with pytest.raises(RuntimeError, match="idle"):
        eng.restore(snap)


def test_restore_reattaches_caller_requests(model, packs):
    eng = _eng(model, packs["fp"])
    reqs = _reqs(2)
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    snap = eng.snapshot()
    assert snap["requests"], "kill point too late: nothing in flight"
    fresh = _eng(model, packs["fp"])
    held = {r.rid: r for r in reqs if not r.done}
    restored = fresh.restore(snap, held)
    assert restored and all(r is held[r.rid] for r in restored)
    assert fresh.stats.restored_requests == len(restored)
    assert all(m.preempts >= 1 for r, m in fresh.scheduler.pending
               if r.output)
    bad = {rid: Request(rid=rid, prompt=[1, 2, 3]) for rid in held}
    with pytest.raises(SnapshotIntegrityError, match="prompt"):
        _eng(model, packs["fp"]).restore(snap, bad)


def test_restore_bypasses_shed_policy(model, packs):
    eng = _eng(model, packs["fp"])
    reqs = _reqs(3)
    for r in reqs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    snap = eng.snapshot()
    assert len(snap["requests"]) == 3
    fresh = _eng(model, packs["fp"], max_queue_depth=1, shed_policy="reject")
    restored = fresh.restore(snap, {r.rid: r for r in reqs})
    assert len(restored) == 3 and fresh.stats.requests_shed == 0
    fresh.run()
    fresh.check_arena()
    assert fresh.stats.latency_summary()["states"] == {"completed": 3}
