"""Pack integrity: build-time fingerprints + load-time bounds validation.

ESPIM's static data-dependent scheduling bets everything on *decoupled*
index and value planes compiled offline: a single flipped bit in an index
plane silently gathers the wrong ``x`` elements and poisons every
downstream token, and a schedule (perm / chunk plan / width buckets)
paired with the wrong pack is undetectable at trace time — the kernels
only see well-shaped int32 arrays.  The serving contract is therefore
"static but verified":

* every offline pack builder (``pack_ell`` / ``chunk_pack`` /
  ``pack_bucketed_stack``) records a **per-plane fingerprint** (sha256
  over dtype + shape + bytes of each index plane, value plane, valid
  mask, perm and quantized codes/scales) plus a **bound pack digest**
  that also covers the SDDS plan, so plane corruption AND
  schedule<->pack mismatch both change the digest;
* every upload path (``ops.pack_to_device``, ``sparsify_model`` /
  ``verify_sparse`` at engine init) recomputes and compares, and
  additionally **bounds-validates** what hashing alone cannot interpret:
  chunk-local column ids against the input dim, perm/inv_perm mutual
  consistency, quantized codes against their per-group bit widths and
  the scale-group layout.

Everything here is host-side numpy — verification runs once per upload,
never on the per-token path.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

__all__ = [
    "PackIntegrityError",
    "array_digest",
    "fingerprint_planes",
    "bind_fingerprint",
    "plan_fingerprint",
    "pack_planes",
    "fingerprint_pack",
    "validate_pack",
    "verify_pack",
    "validate_perm_layers",
]


class PackIntegrityError(RuntimeError):
    """A pack failed fingerprint verification or bounds validation."""


# --------------------------------------------------------------------------
# Fingerprints
# --------------------------------------------------------------------------
def array_digest(arr) -> str:
    """sha256 over dtype + shape + raw bytes of one plane (any array-like,
    device arrays included — they round-trip through numpy byte-exact)."""
    a = np.ascontiguousarray(np.asarray(arr))
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(repr(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def fingerprint_planes(planes: dict) -> dict:
    return {name: array_digest(a) for name, a in planes.items()
            if a is not None}


def bind_fingerprint(plane_fps: dict, meta: dict | None = None) -> str:
    """Bind per-plane digests + static meta (geometry, quant layout, the
    SDDS plan digest) into one pack digest."""
    doc = {"planes": dict(sorted(plane_fps.items())), "meta": meta or {}}
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True, default=str).encode()).hexdigest()


def plan_fingerprint(plan) -> str:
    """Digest of an SDDS schedule artifact (ChunkPlan / WidthBucketPlan /
    Schedule / PackGroupSpec dataclass) — the schedule side of the
    schedule<->pack binding."""
    if plan is None:
        return "none"
    doc = dataclasses.asdict(plan) if dataclasses.is_dataclass(plan) \
        else dict(plan)
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True, default=str).encode()).hexdigest()


def _qplane_planes(prefix: str, plane) -> dict:
    return {f"{prefix}q": plane.q,
            f"{prefix}scales": plane.scales,
            f"{prefix}group_bits": plane.group_bits}


def pack_planes(pack) -> tuple[dict, dict]:
    """(named planes, static meta) of any offline pack — ``ELLPack``,
    ``ELLChunkedPack`` or ``BucketedStackedPack``, fp or quantized
    (duck-typed so this module imports nothing from the format module)."""
    if hasattr(pack, "buckets"):                    # BucketedStackedPack
        planes = {"perm": pack.perm, "inv_perm": pack.inv_perm}
        for g, b in enumerate(pack.buckets):
            planes[f"b{g}.values"] = b["values"]
            planes[f"b{g}.cols"] = b["cols"]
            planes[f"b{g}.valid"] = b["valid"]
        if pack.qplanes is not None:
            for g, p in enumerate(pack.qplanes):
                planes.update(_qplane_planes(f"b{g}.", p))
        meta = {"kind": "bucketed_stack", "halves": pack.halves,
                "n_rows": pack.n_rows, "n_cols": pack.n_cols,
                "chunk_cols": pack.chunk_cols, "row_tile": pack.row_tile,
                "bucket_rows": list(pack.bucket_rows),
                "plan": plan_fingerprint(pack.plan)}
        return planes, meta
    planes = {"values": pack.values, "cols": pack.cols,
              "valid": pack.valid, "perm": pack.perm}
    qp = getattr(pack, "qplane", None)
    if qp is not None:
        planes.update(_qplane_planes("", qp))
    meta = {"kind": "ell_chunked" if pack.values.ndim == 3 else "ell",
            "n_rows": pack.n_rows, "n_cols": pack.n_cols,
            "row_tile": pack.row_tile,
            "chunk_cols": getattr(pack, "chunk_cols", None),
            "plan": plan_fingerprint(getattr(pack, "plan", None))}
    return planes, meta


def fingerprint_pack(pack) -> dict:
    """{"planes": {name: digest}, "meta": ..., "pack": bound digest}."""
    planes, meta = pack_planes(pack)
    fps = fingerprint_planes(planes)
    return {"planes": fps, "meta": meta, "pack": bind_fingerprint(fps, meta)}


def diverging_planes(expected: dict, got: dict) -> list:
    exp_p = expected.get("planes", {})
    got_p = got.get("planes", {})
    return sorted(k for k in set(exp_p) | set(got_p)
                  if exp_p.get(k) != got_p.get(k))


# --------------------------------------------------------------------------
# Bounds validation (what hashing cannot interpret)
# --------------------------------------------------------------------------
def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise PackIntegrityError(msg)


def validate_chunked_planes(what: str, values, cols, valid,
                            chunk_cols: int, n_cols: int) -> None:
    """Bounds-validate one (..., K, Lc) chunked plane set: chunk-local
    column ids must address real ``x`` elements (the last chunk is
    narrower than ``chunk_cols`` when ``n_cols`` is not a multiple), pad
    slots must be inert, fp values finite."""
    cols = np.asarray(cols)
    valid = np.asarray(valid, bool)
    _check(cols.shape == valid.shape,
           f"{what}: cols/valid shape mismatch {cols.shape} vs {valid.shape}")
    k = cols.shape[-2]
    lim = np.minimum(chunk_cols, n_cols - np.arange(k) * chunk_cols)
    lim = lim.reshape((1,) * (cols.ndim - 2) + (k, 1))
    _check(not (valid & ((cols < 0) | (cols >= lim))).any(),
           f"{what}: index plane out of bounds for input dim {n_cols} "
           f"(chunk_cols={chunk_cols})")
    _check(not cols[~valid].any(),
           f"{what}: pad slots of the index plane must be zero")
    if values is not None:
        values = np.asarray(values)
        _check(values.shape == cols.shape,
               f"{what}: values/cols shape mismatch "
               f"{values.shape} vs {cols.shape}")
        _check(bool(np.isfinite(values).all()),
               f"{what}: non-finite entries in the value plane")
        _check(not values[~valid].any(),
               f"{what}: pad slots of the value plane must be zero")


def validate_qplane(what: str, plane) -> None:
    """Quantized value plane vs its scale-group layout: codes within each
    group's bit width, one finite scale per ``group_rows`` rows."""
    q = np.asarray(plane.q)
    scales = np.asarray(plane.scales)
    gbits = np.asarray(plane.group_bits)
    _check(scales.shape == gbits.shape,
           f"{what}: scales/group_bits shape mismatch")
    _check(q.shape[-3] == plane.group_rows * scales.shape[-1],
           f"{what}: scale-group layout mismatch — {q.shape[-3]} rows vs "
           f"{scales.shape[-1]} groups x group_rows={plane.group_rows}")
    _check(bool(np.isfinite(scales).all()),
           f"{what}: non-finite quant scales")
    _check(bool(np.isin(gbits, (4, 8)).all()),
           f"{what}: group_bits entries must be 4 or 8")
    row_bits = np.repeat(gbits, plane.group_rows, axis=-1)
    qmax = np.where(row_bits == 4, 7, 127)[..., :, None, None]
    _check(bool((np.abs(q.astype(np.int32)) <= qmax).all()),
           f"{what}: quant codes exceed their group's bit width")


def validate_perm_layers(what: str, perm, inv_perm, n_rows: int) -> None:
    """(L, r_pad) perm / (L, n_rows) inv_perm mutual consistency — every
    logical row packed exactly once per layer, and the inverse actually
    inverts (a rolled/mispaired schedule fails here even without a
    recorded fingerprint)."""
    perm = np.asarray(perm)
    inv = np.asarray(inv_perm)
    r_pad = perm.shape[-1]
    _check(inv.shape == perm.shape[:-1] + (n_rows,),
           f"{what}: inv_perm shape {inv.shape} inconsistent with perm "
           f"{perm.shape} over {n_rows} rows")
    _check(bool(((perm >= -1) & (perm < n_rows)).all()),
           f"{what}: perm entries out of range [-1, {n_rows})")
    _check(bool(((perm >= 0).sum(axis=-1) == n_rows).all()),
           f"{what}: perm must pack every logical row exactly once")
    _check(bool(((inv >= 0) & (inv < r_pad)).all()),
           f"{what}: inv_perm entries out of range [0, {r_pad})")
    round_trip = np.take_along_axis(perm, inv, axis=-1)
    _check(bool((round_trip == np.arange(n_rows)).all()),
           f"{what}: inv_perm is not the inverse of perm "
           f"(schedule/pack mismatch)")


def _validate_perm_flat(what: str, perm, n_rows: int) -> None:
    perm = np.asarray(perm)
    _check(bool(((perm >= -1) & (perm < n_rows)).all()),
           f"{what}: perm entries out of range [-1, {n_rows})")
    kept = perm[perm >= 0]
    _check(kept.size == n_rows and np.unique(kept).size == n_rows,
           f"{what}: perm must pack every logical row exactly once")


def validate_pack(pack) -> None:
    """Bounds-validate an offline pack (see ``validate_chunked_planes`` /
    ``validate_qplane`` / the perm checks).  Raises PackIntegrityError."""
    if hasattr(pack, "buckets"):                    # BucketedStackedPack
        for g, b in enumerate(pack.buckets):
            validate_chunked_planes(f"bucket {g}", b["values"], b["cols"],
                                    b["valid"], pack.chunk_cols, pack.n_cols)
            if pack.qplanes is not None:
                validate_qplane(f"bucket {g}", pack.qplanes[g])
                _check(np.asarray(pack.qplanes[g].q).shape
                       == b["values"].shape,
                       f"bucket {g}: quant codes shape diverges from the "
                       f"fp plane")
        validate_perm_layers("pack", pack.perm, pack.inv_perm, pack.n_rows)
        return
    values, cols, valid = pack.values, pack.cols, pack.valid
    if values.ndim == 2:                            # plain ELL: one chunk
        values = values[:, None, :]
        cols = cols[:, None, :]
        valid = valid[:, None, :]
        chunk_cols = pack.n_cols
    else:
        chunk_cols = pack.chunk_cols
    validate_chunked_planes("pack", values, cols, valid, chunk_cols,
                            pack.n_cols)
    qp = getattr(pack, "qplane", None)
    if qp is not None:
        validate_qplane("pack", qp)
    _validate_perm_flat("pack", pack.perm, pack.n_rows)


def verify_pack(pack, expected: dict | None = None) -> dict:
    """The upload-time check: bounds-validate, then (when a build-time
    fingerprint is recorded on the pack — or passed explicitly) recompute
    and compare, naming the diverging planes.  Returns the fresh
    fingerprint."""
    validate_pack(pack)
    got = fingerprint_pack(pack)
    if expected is None:
        expected = getattr(pack, "fingerprint", None)
    if expected is not None and expected["pack"] != got["pack"]:
        raise PackIntegrityError(
            "pack fingerprint mismatch (diverged planes: "
            f"{diverging_planes(expected, got) or ['<meta/schedule>']}) — "
            "the pack was corrupted after build or paired with the wrong "
            "schedule")
    return got
