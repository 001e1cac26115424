"""QuantizedValuePlane — the narrow value plane of a packed sparse matrix.

Mirrors the paper's value/index decoupling (contribution 3): only the cell
*values* of a pack are re-encoded; ``cols``, ``perm`` and the SDDS chunk /
width-bucket schedules are untouched, so every kernel keeps its gather
geometry and swaps the fp value block for int8 codes (or nibble-packed
int4) plus one scale per row group.

Storage forms:

* **codes container** (``q``): int8, same shape as the fp plane — what the
  CPU/ref lowerings and the int8 Pallas kernel consume.  int4 codes live
  in [-7, 7] inside the same container; fallback groups hold int8 codes.
* **nibble-packed** (``device_codes()`` when the plane is uniformly int4):
  uint8 with the last dim halved — two codes per byte, low nibble = even
  slot — consumed by the int4 Pallas kernel.
* **serialized** (``to_bytes()``): the honest pin-bytes form — per group,
  4-bit groups are nibble-packed, fallback groups raw int8 — round-trips
  via ``from_bytes`` and is what ``value_bytes`` accounts.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.quant.calibrate import (QMAX, QuantSpec, group_rel_error,
                                   group_scales, quantize_codes)

__all__ = [
    "QuantizedValuePlane",
    "quantize_plane",
    "quantize_pack",
    "quantize_bucketed_stack",
    "dequantize_plane",
    "nibble_pack",
    "nibble_unpack",
]

_MAGIC = b"ESPIMQVP1"


def nibble_pack(codes: np.ndarray) -> np.ndarray:
    """int4 codes (int8 container, last dim even) -> uint8, last dim
    halved.  Slot 2j lands in the low nibble of byte j, slot 2j+1 in the
    high nibble (two's-complement nibbles)."""
    if codes.shape[-1] % 2:
        raise ValueError(f"last dim must be even, got {codes.shape}")
    u = codes.astype(np.uint8) & 0xF
    lo, hi = u[..., 0::2], u[..., 1::2]
    return (lo | (hi << 4)).astype(np.uint8)


def nibble_unpack(packed: np.ndarray) -> np.ndarray:
    """Inverse of ``nibble_pack``: uint8 (..., P) -> int8 (..., 2P)."""
    lo = (packed & 0xF).astype(np.int16)
    hi = (packed >> 4).astype(np.int16)
    lo = np.where(lo > 7, lo - 16, lo)
    hi = np.where(hi > 7, hi - 16, hi)
    out = np.empty(packed.shape[:-1] + (2 * packed.shape[-1],), np.int8)
    out[..., 0::2] = lo
    out[..., 1::2] = hi
    return out


@dataclasses.dataclass
class QuantizedValuePlane:
    """Quantized value plane of shape (..., R, K, Lc) (leading dims stack
    layers); scales/group_bits are (..., G) with G = R // group_rows."""

    q: np.ndarray            # int8 codes container, plane shape
    scales: np.ndarray       # float32 (..., G)
    group_bits: np.ndarray   # uint8 (..., G), entries in {4, 8}
    group_rows: int          # effective rows per scale group
    bits: int                # requested mode: 8 | 4
    nnz: int                 # valid (non-pad) cells in the plane
    spec: QuantSpec | None = None   # the spec that produced this plane
    # (None for hand-built / deserialized planes: consumers that cache by
    # spec — pack_to_device — then requantize rather than trust a match)

    @property
    def plane_shape(self) -> tuple:
        return self.q.shape

    @property
    def n_slots(self) -> int:
        return int(np.prod(self.q.shape))

    @property
    def slots_per_group(self) -> int:
        return self.group_rows * self.q.shape[-2] * self.q.shape[-1]

    @property
    def n_groups(self) -> int:
        return int(np.prod(self.scales.shape))

    @property
    def n_fallback_groups(self) -> int:
        return int((self.group_bits == 8).sum()) if self.bits == 4 else 0

    @property
    def uniform_int4(self) -> bool:
        return self.bits == 4 and bool((self.group_bits == 4).all())

    @property
    def storage(self) -> str:
        """Device storage family: ``"nib4"`` iff every group is 4-bit (the
        nibble kernel needs one uniform byte layout); else ``"i8"``."""
        return "nib4" if self.uniform_int4 else "i8"

    # ------------------------------------------------------------ accounting
    @property
    def value_bytes(self) -> int:
        """Serialized value-plane bytes: per-group packed codes + one f32
        scale per group + (int4 mode) a 1-bit-per-group fallback map."""
        return int(self.value_bytes_by_lead().sum())

    @property
    def bits_per_nnz(self) -> float:
        """Value-plane bits per *useful* cell — the paper's pin metric
        (padding slots and scale overhead charged to the nnz they serve)."""
        return 8.0 * self.value_bytes / max(1, self.nnz)

    def value_bytes_by_lead(self) -> np.ndarray:
        """``value_bytes`` split over the leading (layer-stack) dims:
        shape ``scales.shape[:-1]`` (scalar array for a single plane)."""
        s = self.slots_per_group
        gb = self.group_bits.astype(np.int64)
        code = ((s * gb + 7) // 8).sum(axis=-1)
        meta = 4 * gb.shape[-1]
        if self.bits == 4:
            meta += (gb.shape[-1] + 7) // 8
        return code + meta

    # ------------------------------------------------------------ transforms
    def row_scales(self) -> np.ndarray:
        """Per-row scales, pre-expanded from the per-group table
        (``np.repeat`` over the row axis).  This is the ``srow`` operand
        of the fused serving path and of the kernel GLU epilogue
        (``ops.espim_spmv_batched_quant(..., epilogue="glu", srow=...)``):
        expanding once offline folds the whole dequant into a single
        multiply per launch."""
        return np.repeat(self.scales, self.group_rows, axis=-1)

    # backwards-compatible private alias (pre-PR-10 name)
    _row_scales = row_scales

    def dequantize(self) -> np.ndarray:
        """Reconstruct the fp32 value plane: q * scale per row group."""
        return (self.q.astype(np.float32)
                * self.row_scales()[..., :, None, None])

    def device_codes(self) -> np.ndarray:
        """The array the kernels gather: nibble-packed uint8 (last dim
        halved) for uniformly-int4 planes, else the int8 container."""
        if self.storage != "nib4":
            return self.q
        q = self.q
        if q.shape[-1] % 2:
            q = np.concatenate([q, np.zeros(q.shape[:-1] + (1,), np.int8)],
                               axis=-1)
        return nibble_pack(q)

    # ---------------------------------------------------------- serialization
    def to_bytes(self) -> bytes:
        """Compact on-disk / on-pin form (see module docstring)."""
        head = json.dumps({
            "shape": list(self.q.shape),
            "scales_shape": list(self.scales.shape),
            "group_rows": self.group_rows,
            "bits": self.bits,
            "nnz": self.nnz,
        }).encode()
        gb = self.group_bits.reshape(-1)
        # group-major walk: (..., G, slots_per_group) is a pure reshape
        gview = self.q.reshape(-1, self.scales.shape[-1], self.slots_per_group)
        chunks = []
        for n in range(gview.shape[0]):
            for g in range(gview.shape[1]):
                codes = gview[n, g]
                if gb[n * gview.shape[1] + g] == 4:
                    if codes.shape[-1] % 2:
                        codes = np.concatenate([codes, np.zeros(1, np.int8)])
                    chunks.append(nibble_pack(codes).tobytes())
                else:
                    chunks.append(codes.astype(np.int8).tobytes())
        return b"".join([
            _MAGIC, len(head).to_bytes(4, "little"), head,
            gb.astype(np.uint8).tobytes(),
            self.scales.astype(np.float32).tobytes(),
            *chunks,
        ])

    @classmethod
    def from_bytes(cls, buf: bytes) -> "QuantizedValuePlane":
        if buf[:len(_MAGIC)] != _MAGIC:
            raise ValueError("not a serialized QuantizedValuePlane")
        off = len(_MAGIC)
        hlen = int.from_bytes(buf[off:off + 4], "little")
        off += 4
        meta = json.loads(buf[off:off + hlen].decode())
        off += hlen
        shape = tuple(meta["shape"])
        sshape = tuple(meta["scales_shape"])
        n_groups = int(np.prod(sshape))
        gb = np.frombuffer(buf, np.uint8, n_groups, off).copy()
        off += n_groups
        scales = np.frombuffer(buf, np.float32, n_groups, off).copy()
        off += 4 * n_groups
        spg = meta["group_rows"] * shape[-2] * shape[-1]
        groups = []
        for g in range(n_groups):
            if gb[g] == 4:
                nb = (spg + 1) // 2
                packed = np.frombuffer(buf, np.uint8, nb, off)
                off += nb
                groups.append(nibble_unpack(packed)[:spg])
            else:
                groups.append(np.frombuffer(buf, np.int8, spg, off).copy())
                off += spg
        q = np.stack(groups).reshape(shape)
        return cls(q=q, scales=scales.reshape(sshape),
                   group_bits=gb.reshape(sshape),
                   group_rows=meta["group_rows"], bits=meta["bits"],
                   nnz=meta["nnz"])


def dequantize_plane(q: np.ndarray, scales: np.ndarray,
                     group_rows: int) -> np.ndarray:
    """Free-function dequant for raw arrays (the test oracle)."""
    s = np.repeat(np.asarray(scales, np.float32), group_rows, axis=-1)
    return np.asarray(q, np.float32) * s[..., :, None, None]


def quantize_plane(values: np.ndarray, valid: np.ndarray,
                   spec: QuantSpec) -> QuantizedValuePlane:
    """Quantize a (..., R, K, Lc) value plane per ``spec``.

    int4 mode applies the per-group fallback: groups whose relative L2
    reconstruction error exceeds ``spec.err_bound`` are re-calibrated and
    re-coded at int8 (their scale shrinks by ~qmax8/qmax4, their codes
    widen) — mixed planes keep the int8 container on device, uniformly
    4-bit planes nibble-pack (``storage``).
    """
    values = np.asarray(values, np.float32)
    valid = np.asarray(valid, bool)
    if values.ndim < 3:
        raise ValueError(f"plane must be (..., R, K, Lc), got {values.shape}")
    if values.shape != valid.shape:
        raise ValueError("values/valid shape mismatch")
    group = spec.effective_group(values.shape[-3])
    scales = group_scales(values, valid, spec)
    q = quantize_codes(values, scales, spec.bits, group)
    group_bits = np.full(scales.shape, spec.bits, np.uint8)

    if spec.bits == 4 and spec.err_bound is not None:
        deq = dequantize_plane(q, scales, group)
        err = group_rel_error(values, deq, valid, group)
        fb = err > spec.err_bound
        if fb.any():
            # fallback groups re-calibrate at int8 *absmax* so they carry
            # the LSB guarantee (|err| <= scale/2) whatever the int4 calib
            spec8 = dataclasses.replace(spec, calib="absmax")
            scales8 = group_scales(values, valid, spec8, bits=8)
            q8 = quantize_codes(values, scales8, 8, group)
            sel = np.repeat(fb, group, axis=-1)[..., :, None, None]
            q = np.where(sel, q8, q)
            scales = np.where(fb, scales8, scales).astype(np.float32)
            group_bits = np.where(fb, 8, group_bits).astype(np.uint8)

    return QuantizedValuePlane(q=q, scales=scales, group_bits=group_bits,
                               group_rows=group, bits=spec.bits,
                               nnz=int(valid.sum()), spec=spec)


def quantize_pack(pack, spec: QuantSpec, attach: bool = True
                  ) -> QuantizedValuePlane:
    """Quantize the value plane of an ``ELLPack`` (viewed as K=1) or an
    ``ELLChunkedPack``; ``attach=True`` stores it as ``pack.qplane`` and
    rewrites ``pack.stats`` with the quantized byte accounting."""
    values, valid = pack.values, pack.valid
    if values.ndim == 2:                       # plain ELL: one full-width chunk
        values = values[:, None, :]
        valid = valid[:, None, :]
    plane = quantize_plane(values, valid, spec)
    if attach:
        pack.qplane = plane
        pack.stats = dataclasses.replace(pack.stats,
                                         value_bytes=plane.value_bytes)
        _refresh_fingerprint(pack)
    return plane


def quantize_bucketed_stack(pack, spec: QuantSpec, attach: bool = True
                            ) -> list:
    """Quantize every bucket of a ``BucketedStackedPack``: one plane per
    bucket of shape (L, halves*Rg, K, Lc_g) — scales stack over layers
    exactly like the value arrays, so they scan as one more leaf.  The
    effective group per bucket is gcd(spec.group_rows, halves*Rg)."""
    planes = [quantize_plane(b["values"], b["valid"], spec)
              for b in pack.buckets]
    if attach:
        pack.qplanes = planes
        _refresh_fingerprint(pack)
    return planes


def _refresh_fingerprint(pack) -> None:
    """Attaching quant planes changes the pack's plane set, so the bound
    fingerprint recorded at build must be recomputed (only for packs the
    builders fingerprinted — hand-assembled packs stay unfingerprinted)."""
    if getattr(pack, "fingerprint", None) is not None:
        from repro_torch.core.integrity import fingerprint_pack
        pack.fingerprint = fingerprint_pack(pack)
