"""Calibration: per-row-group scales for the packed value planes.

The unit of calibration is a *row group* — ``group_rows`` consecutive
packed rows, aligned to the ELL row tile so one kernel block covers whole
groups and its scales load once per grid step (the TPU analogue of the
paper's per-bank fixed-point format registers).  All cells of a group —
across every column chunk and every ELL slot — share one symmetric scale:

    q = clip(round(v / scale), -qmax, qmax),     v_hat = q * scale

* ``absmax``: scale = max|v| / qmax — lossless range, LSB-bounded error
  (|v_hat - v| <= scale / 2 for every cell);
* ``percentile``: scale = P-th percentile of |v| over the group's *valid*
  cells / qmax — clips outliers for a smaller step on the bulk (pad slots
  are excluded so the ELL stalls cannot drag the percentile down).

int4 groups whose relative reconstruction error exceeds ``err_bound`` are
re-calibrated at int8 (the per-group fallback rule, DESIGN.md section 9):
narrow values win bytes only where they do not cost accuracy.
"""
from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np

__all__ = ["QMAX", "QuantSpec", "default_spec", "group_scales",
           "quantize_codes", "group_rel_error"]

QMAX = {8: 127, 4: 7}

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """How to quantize one value plane.

    ``group_rows`` is the requested scale-group height; the effective
    height is ``gcd(group_rows, n_packed_rows)`` so groups always tile the
    plane exactly (packs keep rows a multiple of the row tile, so the
    default 128 degrades only on narrow test packs).  ``err_bound`` is the
    per-group relative L2 reconstruction bound that triggers the int4 ->
    int8 fallback; int8 mode never falls back.
    """

    bits: int = 8                 # 8 | 4 (4 = nibble-packed, int8 fallback)
    group_rows: int = 128         # aligned to the ELL row tile
    calib: str = "absmax"         # absmax | percentile
    percentile: float = 99.9
    err_bound: float = 0.12       # int4 -> int8 fallback threshold

    def __post_init__(self):
        if self.bits not in QMAX:
            raise ValueError(f"bits must be one of {sorted(QMAX)}, "
                             f"got {self.bits}")
        if self.calib not in ("absmax", "percentile"):
            raise ValueError(f"unknown calib {self.calib!r}")
        if self.group_rows <= 0:
            raise ValueError("group_rows must be positive")

    def effective_group(self, n_rows: int) -> int:
        return math.gcd(self.group_rows, n_rows) or 1


def default_spec(mode: str) -> QuantSpec:
    """The serving presets: ``"int8"`` (absmax — LSB-exact range) and
    ``"int4"`` (99.9th-percentile clip: on magnitude-pruned planes the
    surviving values are the top-|v| tail, where a light clip roughly
    halves the int4 step and keeps groups under the fallback bound)."""
    if mode == "int8":
        return QuantSpec(bits=8)
    if mode == "int4":
        return QuantSpec(bits=4, calib="percentile", percentile=99.9)
    raise ValueError(f"unknown quant mode {mode!r} (int8 | int4)")


def _group_view(plane: np.ndarray, group: int) -> np.ndarray:
    """(..., R, K, Lc) -> (..., G, group * K * Lc): one row per scale group."""
    *lead, r, k, lc = plane.shape
    return plane.reshape(*lead, r // group, group * k * lc)


def group_scales(values: np.ndarray, valid: np.ndarray, spec: QuantSpec,
                 bits: int | None = None) -> np.ndarray:
    """Per-group scales for a (..., R, K, Lc) plane -> (..., G) float32.

    All-zero (or all-pad) groups get scale 1.0 so dequantization is always
    a plain multiply with no zero-guard on the hot path.
    """
    bits = spec.bits if bits is None else bits
    qmax = QMAX[bits]
    group = spec.effective_group(values.shape[-3])
    av = np.abs(_group_view(values, group)).astype(np.float64)
    if spec.calib == "absmax":
        amax = av.max(axis=-1)
    else:
        masked = np.where(_group_view(valid, group), av, np.nan)
        with np.errstate(all="ignore"), warnings.catch_warnings():
            # all-pad groups are legal: they resolve to scale 1.0 below
            warnings.simplefilter("ignore", RuntimeWarning)
            amax = np.nanpercentile(masked, spec.percentile, axis=-1)
        amax = np.where(np.isfinite(amax), amax, 0.0)
        # never clip below the group's own resolution floor
        amax = np.maximum(amax, av.max(axis=-1) / (2.0 * qmax))
    scales = amax / qmax
    return np.where(scales > 0, scales, 1.0).astype(np.float32)


def quantize_codes(values: np.ndarray, scales: np.ndarray, bits: int,
                   group: int) -> np.ndarray:
    """Symmetric round-to-nearest codes: (..., R, K, Lc) int8 in
    [-qmax, qmax] (int4 codes occupy the same int8 container; nibble
    packing is a storage transform — ``qpack.nibble_pack``)."""
    qmax = QMAX[bits]
    s = np.repeat(scales, group, axis=-1)[..., :, None, None]
    q = np.rint(values.astype(np.float64) / s)
    return np.clip(q, -qmax, qmax).astype(np.int8)


def group_rel_error(values: np.ndarray, deq: np.ndarray, valid: np.ndarray,
                    group: int) -> np.ndarray:
    """Per-group relative L2 reconstruction error over valid cells."""
    v = _group_view(np.where(valid, values, 0.0), group).astype(np.float64)
    e = _group_view(np.where(valid, deq - values, 0.0), group)
    return (np.linalg.norm(e, axis=-1)
            / (np.linalg.norm(v, axis=-1) + _EPS))
