"""Fingerprint-keyed plan cache for tuned SDDS kernel schedules.

The cache key must be *plan-independent*: the bound pack digest of a
chunked pack covers its ChunkPlan (schedule<->pack binding, the integrity
contract), so a plan chosen by the autotuner would change the digest it is
keyed under.  The key therefore derives from content that does not move
when the schedule does:

* a plain ``ELLPack`` (the offline artifact *before* the SDDS chunk pass)
  is plan-free by construction — its bound digest covers the value/index
  planes, perm and geometry only, so the same weight content maps to the
  same key no matter which chunk width the tuner later picks;
* an already-chunked pack keys off its per-plane digests + meta minus the
  plan entry; its ``chunk_cols`` is fixed by the artifact, so the search
  is restricted to the launch knobs (documented in DESIGN.md §15).

The launch context (batch width, quant mode, impl, backend) is folded into
the key too — a plan tuned for int4 decode at B=8 says nothing about fp
prefill at B=256.

Entries are ``{"schedule": {...}, "best_us": float|None, "candidates":
int, "created_by": "search"}``; ``PlanCache(path=...)`` persists the table
as JSON (atomic tmp+rename on every put) so a second process starts warm.
``ESPIM_PLAN_CACHE`` names the default on-disk location; unset, the
default cache is in-memory only.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile

from repro_torch.core.integrity import bind_fingerprint, fingerprint_pack

__all__ = ["PlanCache", "pack_cache_key", "default_cache",
           "reset_default_cache", "ENV_PLAN_CACHE"]

ENV_PLAN_CACHE = "ESPIM_PLAN_CACHE"

# the port's schedules carry Hopper knobs (warps a row, U), so a table
# the JAX package wrote (TPU block sizes) reads as foreign and starts empty
CACHE_SCHEMA = "espim-plan-cache/torch-v1"


def _plan_free_digest(pack) -> str:
    """A digest of the pack that is invariant to the SDDS chunk plan."""
    fp = getattr(pack, "fingerprint", None)
    if fp is None:
        fp = fingerprint_pack(pack)
    meta = {k: v for k, v in fp["meta"].items()
            if k not in ("plan", "chunk_cols")}
    if fp["meta"].get("kind") == "ell":
        # the un-chunked artifact: planes are chunk-invariant already
        return bind_fingerprint(fp["planes"], meta)
    # chunked artifact: planes moved with the chunk pass; the key pins the
    # exact planes (so re-chunking retunes) but drops the plan digest so
    # launch-knob retuning of the same layout stays one entry
    return bind_fingerprint(fp["planes"], meta)


def pack_cache_key(pack, *, b: int, quant: str | None, impl: str,
                   backend: str) -> str:
    """sha256 cache key: plan-free pack digest + launch context."""
    doc = {
        "pack": _plan_free_digest(pack),
        "b": int(b),
        "quant": quant or "none",
        "impl": impl,
        "backend": backend,
    }
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()[:32]


class PlanCache:
    """JSON-backed table of tuned plans: key -> plan record.

    ``path=None`` keeps the table in memory; with a path, the table loads
    lazily on first access and every ``put`` rewrites the file atomically.
    ``hits``/``misses`` count lookups for the warm-cache assertions.
    """

    def __init__(self, path: str | None = None):
        self.path = path
        self.hits = 0
        self.misses = 0
        self._table: dict | None = None

    def _load(self) -> dict:
        if self._table is None:
            self._table = {}
            if self.path and os.path.exists(self.path):
                try:
                    doc = json.load(open(self.path))
                    if doc.get("schema") == CACHE_SCHEMA:
                        self._table = dict(doc.get("plans", {}))
                except (OSError, ValueError):
                    pass        # corrupt/foreign file: start empty
        return self._table

    def __len__(self) -> int:
        return len(self._load())

    def get(self, key: str) -> dict | None:
        entry = self._load().get(key)
        if entry is None:
            self.misses += 1
        else:
            self.hits += 1
        return entry

    def put(self, key: str, entry: dict) -> None:
        table = self._load()
        table[key] = dict(entry)
        if self.path:
            self._save(table)

    def _save(self, table: dict) -> None:
        doc = {"schema": CACHE_SCHEMA, "plans": table}
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def clear(self) -> None:
        self._table = {}
        if self.path and os.path.exists(self.path):
            os.unlink(self.path)


_DEFAULT: PlanCache | None = None


def default_cache() -> PlanCache:
    """The process-wide cache ``pack_to_device(autotune=True)`` uses —
    on-disk when ``ESPIM_PLAN_CACHE`` names a path, else in-memory."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = PlanCache(os.environ.get(ENV_PLAN_CACHE) or None)
    return _DEFAULT


def reset_default_cache() -> None:
    """Drop the process-wide cache (tests; env re-reads on next use)."""
    global _DEFAULT
    _DEFAULT = None
