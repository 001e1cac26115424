"""Crash-consistent engine snapshot/restore (mirrors
``src/repro/serve/snapshot.py``).

ESPIM's sparsity plan is static and verified before inference, so every
per-request serving state is a pure function of (model pack, prompt,
committed tokens).  A snapshot therefore saves only the *control plane*
— scheduler queue, per-request committed token history, slot residency,
block-table shape — and none of the KV planes: on restore each request
re-enters the queue and the engine recomputes its KV history through the
ordinary resume path (re-prefill of prompt + committed tokens), emitting
remaining greedy tokens bit-for-bit identical to a never-interrupted
run.  That keeps snapshots a few KB regardless of arena size, and makes
restore trivially crash-consistent: there is no moment where half a KV
plane is on disk.

Format: a plain JSON-ready dict —

    {"version": 1,
     "model": cfg.name, "max_len": ..., "temperature": ...,
     "pack_fingerprint": <model-level pack digest or "dense">,
     "rng_key": [..],                     # engine generator state bytes
     "geometry": {slots, block_size, num_blocks},
     "requests": [{rid, prompt, output, max_new_tokens, eos_id,
                   deadline_s, ttft_deadline_s, origin, slot,
                   preempts}, ...],       # slot residents first, then
                                          # wait queue in queue order
     "stats": {tokens_generated, preempts, requests_shed},   # info only
     "digest": sha256(canonical JSON of everything above)}

Two bindings gate a restore: the ``digest`` (bit-rot / truncation of the
snapshot itself) and the ``pack_fingerprint`` (the snapshot must be
restored against the *same* verified pack — restoring a token history
onto different weights would silently complete requests with the wrong
model).  Both raise ``SnapshotIntegrityError`` (a ``PackIntegrityError``
subclass, so existing fault handling catches it).

Snapshots are taken at step boundaries (``ServeEngine.snapshot()``
between ``step()`` calls); a snapshot mid-step would be torn by
definition.  The crash drill in ``serve/faults.py`` exercises the whole
loop: kill at an arbitrary step, restore, assert exact output parity and
zero leaked blocks.
"""
from __future__ import annotations

import hashlib
import json
import time

from repro_torch.core.integrity import PackIntegrityError
from repro_torch.serve.scheduler import RequestMetrics

__all__ = ["SNAPSHOT_VERSION", "SnapshotIntegrityError", "snapshot_engine",
           "restore_engine", "snapshot_digest", "validate_snapshot",
           "dumps", "loads"]

SNAPSHOT_VERSION = 1


class SnapshotIntegrityError(PackIntegrityError):
    """A snapshot failed digest verification, version, or pack binding."""


def _engine_fingerprint(eng) -> str:
    """The model identity a snapshot binds to: the model-level pack
    digest for a sparse engine, a named dense marker otherwise."""
    if eng.sparse is not None and "fingerprint" in eng.sparse:
        return str(eng.sparse["fingerprint"])
    return f"dense:{eng.cfg.name}"


def snapshot_digest(doc: dict) -> str:
    """sha256 over the canonical JSON of everything except ``digest``."""
    body = {k: v for k, v in doc.items() if k != "digest"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True, default=str).encode()).hexdigest()


def _request_entry(req, m: RequestMetrics, origin: str,
                   slot: int | None) -> dict:
    return {
        "rid": int(req.rid),
        "prompt": [int(t) for t in req.prompt],
        "output": [int(t) for t in req.output],
        "max_new_tokens": int(req.max_new_tokens),
        "eos_id": int(req.eos_id),
        "deadline_s": req.deadline_s,
        "ttft_deadline_s": req.ttft_deadline_s,
        "origin": origin,              # "slot" | "queue"
        "slot": slot,
        "preempts": int(m.preempts),
    }


def snapshot_engine(eng) -> dict:
    """Serialize the engine's control plane at a step boundary.  KV
    planes are deliberately NOT captured — they are recomputed on
    restore from each request's committed history."""
    requests = []
    for i, st in enumerate(eng.slots):
        if st is None:
            continue
        requests.append(_request_entry(st.req, st.metrics, "slot", i))
    for req, m in eng.scheduler.pending:
        requests.append(_request_entry(req, m, "queue", None))
    doc = {
        "version": SNAPSHOT_VERSION,
        "model": eng.cfg.name,
        "max_len": int(eng.max_len),
        "temperature": float(eng.temperature),
        "pack_fingerprint": _engine_fingerprint(eng),
        # torch.Generator.get_state() is a CPU uint8 tensor, for a CUDA
        # generator too
        "rng_key": [int(w) for w in eng._gen.get_state().tolist()],
        "geometry": {
            "slots": int(eng.b),
            "block_size": int(getattr(eng.cache, "block_size", 0)),
            "num_blocks": int(getattr(eng.cache, "num_blocks", 0)),
        },
        # per-slot block counts at capture time: restore recomputes KV,
        # so these are recorded for observability/validation only
        "block_tables": {
            str(i): int(eng.cache.n_blocks[i])
            for i in range(eng.b)
            if getattr(eng.cache, "n_blocks", None) is not None
            and int(eng.cache.n_blocks[i])
        } if eng.paged else {},
        "requests": requests,
        "stats": {
            "tokens_generated": int(eng.stats.tokens_generated),
            "preempts": int(eng.stats.preempts),
            "requests_shed": int(eng.stats.requests_shed),
        },
    }
    doc["digest"] = snapshot_digest(doc)
    return doc


def dumps(snap: dict) -> str:
    return json.dumps(snap, sort_keys=True)


def loads(text: str) -> dict:
    snap = json.loads(text)
    validate_snapshot(snap)
    return snap


def validate_snapshot(snap: dict) -> None:
    """Structural + digest validation (no engine needed)."""
    if not isinstance(snap, dict) or "version" not in snap:
        raise SnapshotIntegrityError("not an engine snapshot")
    if snap["version"] != SNAPSHOT_VERSION:
        raise SnapshotIntegrityError(
            f"snapshot version {snap['version']} not supported "
            f"(expected {SNAPSHOT_VERSION})")
    want = snap.get("digest")
    got = snapshot_digest(snap)
    if want != got:
        raise SnapshotIntegrityError(
            f"snapshot digest mismatch: recorded {want!r}, "
            f"recomputed {got!r} — truncated or bit-rotted snapshot")


def restore_engine(eng, snap: dict, requests: dict | None = None) -> list:
    """Re-admit every request from ``snap`` into a fresh engine.

    The engine must be idle (no resident slots, empty queue) and must be
    serving the same pack (fingerprint-bound) with the same ``max_len``
    (the max-length stop condition is part of greedy parity).  Requests
    re-enter the wait queue in snapshot order — slot residents first —
    bypassing the shed policy (restored work is not new load); any
    request with committed output is shielded from future shedding the
    same way preempted requests are, and resumes through the engine's
    recompute path.  ``requests`` optionally maps rid -> caller-held
    ``Request`` objects to reattach (so a caller's handles keep
    receiving tokens); otherwise fresh Request objects are built.
    Returns the restored Request list in admission order.
    """
    from repro_torch.serve.engine import Request

    validate_snapshot(snap)
    fp = _engine_fingerprint(eng)
    if snap["pack_fingerprint"] != fp:
        raise SnapshotIntegrityError(
            f"snapshot is bound to pack {snap['pack_fingerprint'][:16]}…, "
            f"engine is serving {fp[:16]}… — refusing to resume a token "
            f"history onto different weights")
    if snap["model"] != eng.cfg.name:
        raise SnapshotIntegrityError(
            f"snapshot from model {snap['model']!r}, engine is "
            f"{eng.cfg.name!r}")
    if int(snap["max_len"]) != int(eng.max_len):
        raise SnapshotIntegrityError(
            f"snapshot max_len {snap['max_len']} != engine "
            f"{eng.max_len} — the length stop is part of greedy parity")
    if any(s is not None for s in eng.slots) or eng.scheduler.has_pending:
        raise RuntimeError("restore() needs an idle engine: drain or "
                           "build a fresh one first")

    key = snap.get("rng_key")
    if key:
        import torch
        eng._gen.set_state(torch.tensor(key, dtype=torch.uint8))

    restored = []
    now = time.monotonic()
    for entry in snap["requests"]:
        rid = entry["rid"]
        req = (requests or {}).get(rid)
        if req is None:
            req = Request(rid=rid, prompt=list(entry["prompt"]),
                          max_new_tokens=entry["max_new_tokens"],
                          eos_id=entry["eos_id"],
                          deadline_s=entry["deadline_s"],
                          ttft_deadline_s=entry["ttft_deadline_s"])
        elif list(req.prompt) != list(entry["prompt"]):
            raise SnapshotIntegrityError(
                f"reattached request {rid} prompt differs from snapshot")
        req.output = list(entry["output"])
        req.done = False
        m = RequestMetrics(rid=rid, prompt_len=len(req.prompt),
                           t_submit=now)
        m.preempts = entry["preempts"]
        if req.output and m.preempts == 0:
            m.preempts = 1      # committed tokens: never sheddable
        # deliberate pending.append, not scheduler.add(): restore
        # bypasses the bounded-queue shed policy — so it emits its own
        # queued mark to keep every lifecycle reconstructable
        eng.scheduler._mark("req.queued", {"rid": rid,
                                           "prompt_len": m.prompt_len,
                                           "restored": True})
        eng.scheduler.pending.append((req, m))
        eng.stats.restored_requests += 1
        eng._c_restores.inc()
        info = {"rid": rid, "committed": len(req.output),
                "origin": entry["origin"]}
        eng.tracer.instant("fault.restore", cat="fault", args=info)
        eng.flight.record("fault", "fault.restore", info)
        restored.append(req)
    eng._g_queue_depth.set(eng.scheduler.queue_depth)
    return restored
