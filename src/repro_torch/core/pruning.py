"""Magnitude pruning and SparTen-style greedy load balancing.

The paper (Section IV "Benchmarks") prunes LLaMA-7B weight matrices with
magnitude thresholds per Han et al. [20] to reach target sparsities; it does
not retrain (cycle counts depend only on the sparsity *pattern*).  Section
III-G adopts SparTen's greedy balance: sort rows by density, deal them
round-robin across banks, and within each bank co-locate the densest row with
the sparsest so paired rows have near-uniform combined work.

Everything here is *offline* (host-side, numpy) — it is part of the SDDS
compilation pipeline, not the device program.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "magnitude_prune",
    "prune_to_pattern",
    "BankAssignment",
    "sparten_balance",
    "row_tile_balance",
]


def magnitude_prune(w: np.ndarray, sparsity: float) -> np.ndarray:
    """Zero out the smallest-|w| fraction ``sparsity`` of entries.

    Returns a new array; the induced pattern is what SDDS schedules.
    ``sparsity`` is the fraction of *zeros* (0.9 == 90% zeros).
    """
    if not 0.0 <= sparsity < 1.0:
        raise ValueError(f"sparsity must be in [0, 1), got {sparsity}")
    if sparsity == 0.0:
        return np.array(w, copy=True)
    flat = np.abs(np.asarray(w)).ravel()
    k = int(round(sparsity * flat.size))
    if k == 0:
        return np.array(w, copy=True)
    if k >= flat.size:
        return np.zeros_like(w)
    # Threshold at the k-th smallest magnitude (Han et al. style).
    thresh = np.partition(flat, k - 1)[k - 1]
    out = np.array(w, copy=True)
    out[np.abs(out) <= thresh] = 0.0
    # Tie-breaking at the threshold can overshoot; that is fine (the paper's
    # thresholds are approximate too), but never undershoot badly.
    return out


def prune_to_pattern(w: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Apply an externally supplied keep-mask (1 = keep)."""
    if mask.shape != w.shape:
        raise ValueError(f"mask shape {mask.shape} != weight shape {w.shape}")
    return np.where(mask.astype(bool), w, np.zeros_like(w))


@dataclasses.dataclass(frozen=True)
class BankAssignment:
    """Result of SparTen greedy balance.

    ``bank_rows[b]`` lists original-matrix row ids assigned to bank ``b`` in
    *processing order* (densest/sparsest co-located pairs, intermingled in
    logically-increasing index order as Section III-G requires).
    ``select_bit[b]`` carries the per-row output-buffer select bit (two
    output buffers per bank).
    """

    bank_rows: tuple  # tuple[tuple[int, ...], ...]
    select_bit: tuple  # tuple[tuple[int, ...], ...]
    n_banks: int

    def max_rows_per_bank(self) -> int:
        return max((len(r) for r in self.bank_rows), default=0)


def sparten_balance(nnz_per_row: Sequence[int], n_banks: int) -> BankAssignment:
    """SparTen greedy balance (Section III-G).

    1. Sort rows by density (nnz) descending.
    2. Deal sorted rows round-robin to banks -> each bank holds a density-
       sorted list.
    3. Within each bank, pair densest with sparsest (first/last, second/
       second-last, ...) so synchronous stripes have near-equal work; the
       pair members keep logically-increasing row order and are tagged with
       alternating select bits for the two output buffers.
    """
    nnz = np.asarray(nnz_per_row, dtype=np.int64)
    order = np.argsort(-nnz, kind="stable")  # densest first
    per_bank: list[list[int]] = [[] for _ in range(n_banks)]
    for i, row in enumerate(order):
        per_bank[i % n_banks].append(int(row))

    bank_rows: list[tuple[int, ...]] = []
    select_bit: list[tuple[int, ...]] = []
    for rows in per_bank:
        # rows is densest..sparsest; fold: d0, s0, d1, s1 ...
        folded: list[int] = []
        sel: list[int] = []
        lo, hi = 0, len(rows) - 1
        take_dense = True
        while lo <= hi:
            if take_dense:
                pick = rows[lo]
                lo += 1
                sel.append(0)
            else:
                pick = rows[hi]
                hi -= 1
                sel.append(1)
            folded.append(pick)
            take_dense = not take_dense
        # "intermingled in logically-increasing index order": within each
        # co-located pair keep the smaller original index first, preserving
        # the select-bit association with the row (not the slot).
        for j in range(0, len(folded) - 1, 2):
            if folded[j] > folded[j + 1]:
                folded[j], folded[j + 1] = folded[j + 1], folded[j]
                sel[j], sel[j + 1] = sel[j + 1], sel[j]
        bank_rows.append(tuple(folded))
        select_bit.append(tuple(sel))
    return BankAssignment(
        bank_rows=tuple(bank_rows), select_bit=tuple(select_bit), n_banks=n_banks
    )


def row_tile_balance(nnz_per_row: Sequence[int], tile: int) -> np.ndarray:
    """TPU adaptation of SparTen balance: permute rows to minimize ELL
    padding (the padding slots play the role of SDDS stall/dummy cells).

    A tile's padded width is its *max* nnz, so rows of similar density must
    be CLUSTERED, not spread: sort by nnz descending and chunk
    consecutively — each tile's max is then as close to its mean as the
    distribution allows.  (This is the dual of the paper's bank balance,
    which equalizes *sums* across lockstep banks; that variant lives in
    ``sparten_balance`` and drives the cycle simulator.)

    Returns ``perm`` with ``perm[i]`` = original row id at packed position
    ``i``.
    """
    nnz = np.asarray(nnz_per_row, dtype=np.int64)
    return np.argsort(-nnz, kind="stable")
