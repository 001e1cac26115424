"""The weights an ESPIM deployment serves, worked out again from the raw
weights: magnitude pruning, then the codes of the value planes.

A value's scale is shared by consecutive rows of its pack's *packed*
order (one bucket of one group, one layer), so the scales depend on that
order: the rows sorted by their nonzero count, and the cut of the packed
rows into width buckets.  This file is a frozen copy of that arithmetic
as the offline pack compiler of the served program defines it (prune ->
fuse -> balance -> chunk -> width-bucket -> quantize), written in plain
PyTorch and Python so that the reference depends on nothing the program
computes.  The pack groups are the family's (``reference/<family>.py``,
``GROUPS``), the value code the configuration's
(``reference/codes/<quant>.py``).  It yields dense (L, in, out) float32
matrices: pruned, and dequantized where the configuration quantizes.
"""
from __future__ import annotations

import math

import torch

__all__ = ["magnitude_prune", "plan_width_buckets", "served_projections",
           "row_scales"]

ROW_TILE = 128          # packed rows are padded to a multiple of this
PLAN_ROWS = 32          # row granularity of the width-bucket plan
WIDTH_MULTIPLE = 8      # bucket widths round up to this
N_BUCKETS = 4
SLACK = 0.02            # a further bucket must save this share


def magnitude_prune(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Zero the smallest-|w| share ``sparsity`` of one matrix's entries:
    every entry whose magnitude is at most the k-th smallest, k =
    round(sparsity * size) (ties at the threshold go too)."""
    n = w.numel()
    k = int(round(sparsity * n))
    if sparsity == 0.0 or k == 0:
        return w.clone()
    if k >= n:
        return torch.zeros_like(w)
    thresh = torch.kthvalue(w.abs().flatten(), k).values
    return torch.where(w.abs() <= thresh, torch.zeros_like(w), w)


def _bucket_width(w: int) -> int:
    return max(WIDTH_MULTIPLE, -(-max(int(w), 1) // WIDTH_MULTIPLE)
               * WIDTH_MULTIPLE)


def plan_width_buckets(widths, rows_per_group: int) -> list:
    """Cut the packed rows into at most ``N_BUCKETS`` contiguous buckets,
    each padded to its own width: exact least padding over groups of
    ``rows_per_group`` rows, and of the bucket counts within ``SLACK`` of
    the least, the fewest.  ``widths[g]`` is the most cells any row of
    group g holds in one column chunk.  Returns [(row0, row1, width)]."""
    widths = [int(w) for w in widths]
    n = len(widths)
    nb = max(1, min(N_BUCKETS, n))
    seg_max = [[0] * (n + 1) for _ in range(n)]
    for i in range(n):
        m = 0
        for j in range(i + 1, n + 1):
            m = max(m, widths[j - 1])
            seg_max[i][j] = _bucket_width(m)

    def cost(i, j):
        return (j - i) * rows_per_group * seg_max[i][j]

    inf = float("inf")
    best = [[inf] * (n + 1) for _ in range(nb + 1)]
    back = [[0] * (n + 1) for _ in range(nb + 1)]
    best[0][0] = 0
    for k in range(1, nb + 1):
        prev, cur, bk = best[k - 1], best[k], back[k]
        for j in range(1, n + 1):
            for i in range(k - 1, j):
                if prev[i] == inf:
                    continue
                c = prev[i] + cost(i, j)
                if c < cur[j]:
                    cur[j] = c
                    bk[j] = i
    single = cost(0, n)
    optimum = min(best[k][n] for k in range(1, nb + 1))
    chosen = next(k for k in range(1, nb + 1)
                  if best[k][n] <= optimum + SLACK * single)
    cuts, j = [n], n
    for k in range(chosen, 0, -1):
        j = back[k][j]
        cuts.append(j)
    cuts.reverse()
    return [(cuts[i] * rows_per_group, cuts[i + 1] * rows_per_group,
             seg_max[cuts[i]][cuts[i + 1]]) for i in range(chosen)]


def _group_rows_matrices(pruned: dict, names, fuse: str) -> list:
    """The group's halves as (L, rows, cols) matrices whose rows are the
    projections' output dims."""
    mats = [pruned[n].transpose(1, 2) for n in names]
    if fuse == "halves":
        return mats
    return [torch.cat(mats, dim=1)]


def _packed_order(halves: list, chunk_cols: int, upstream_inv=None):
    """Per layer the rows sorted by their joint nonzero count (stable, most
    first), and the width-bucket plan of the whole stack.  ``upstream_inv``
    (L, cols): where each column sits in the gather domain when the
    group's columns follow an upstream group's packed order.  Returns
    (perm (L, rows), inv_perm (L, rows), buckets [(row0, row1, width)])."""
    n_layers, n_rows, n_cols = halves[0].shape
    dom = n_cols if upstream_inv is None else -(-n_cols // ROW_TILE) * ROW_TILE
    r_pad = -(-max(n_rows, 1) // ROW_TILE) * ROW_TILE
    cc = min(chunk_cols, max(1, dom))
    n_chunks = -(-max(dom, 1) // cc)
    group = math.gcd(r_pad, PLAN_ROWS) or 1
    dev = halves[0].device
    perm = torch.empty((n_layers, n_rows), dtype=torch.long, device=dev)
    widths = torch.zeros(r_pad // group, dtype=torch.long, device=dev)
    for l in range(n_layers):
        masks = [h[l] != 0 for h in halves]
        joint = sum(m.sum(dim=1) for m in masks)
        perm[l] = torch.sort(-joint, stable=True).indices
        for m in masks:
            if upstream_inv is not None:
                placed = torch.zeros((n_rows, dom), dtype=torch.bool,
                                     device=dev)
                placed[:, upstream_inv[l]] = m
                m = placed
            full = torch.zeros((r_pad, n_chunks * cc), dtype=torch.int32,
                               device=dev)
            full[:n_rows, :m.shape[1]] = m[perm[l]].to(torch.int32)
            counts = full.view(r_pad, n_chunks, cc).sum(dim=2)
            per_group = counts.view(r_pad // group, group * n_chunks)
            widths = torch.maximum(widths, per_group.amax(dim=1))
    inv = torch.empty_like(perm)
    ar = torch.arange(n_rows, device=dev).expand(n_layers, n_rows)
    inv.scatter_(1, perm, ar)
    buckets = plan_width_buckets(widths.cpu().tolist(), group)
    return perm, inv, buckets


def row_scales(halves: list, perm: torch.Tensor, buckets: list,
               qmax: int, group_rows: int) -> torch.Tensor:
    """The absmax scale of each logical row, (halves, L, rows) float32: a
    bucket's plane holds its rows half-major ([every half's rows of the
    bucket]), and ``gcd(group_rows, plane rows)`` consecutive plane rows
    share max|v| / qmax (1 where they are all zero)."""
    n_layers, n_rows, _ = halves[0].shape
    n_half = len(halves)
    dev = halves[0].device
    absmax = torch.stack([h.abs().amax(dim=2) for h in halves])  # (H, L, R)
    out = torch.ones((n_half, n_layers, n_rows), dtype=torch.float32,
                     device=dev)
    for row0, row1, _ in buckets:
        rg = row1 - row0
        plane = n_half * rg
        eg = math.gcd(group_rows, plane) or 1
        r = torch.arange(plane, device=dev)
        half, packed = r // rg, row0 + r % rg
        real = packed < n_rows
        for l in range(n_layers):
            logical = perm[l][packed.clamp(max=n_rows - 1)]
            vals = torch.where(real, absmax[half, l, logical],
                               torch.zeros((), device=dev))
            gmax = vals.view(plane // eg, eg).amax(dim=1).double()
            scale = gmax / qmax
            scale = torch.where(scale > 0, scale,
                                torch.ones_like(scale)).float()
            per_row = scale.repeat_interleave(eg)
            out[half[real], l, logical[real]] = per_row[real]
    return out


def served_projections(raw: dict, groups, sparsity: float, codes,
                       chunk_cols: int) -> tuple:
    """({projection: (L, in, out) float32} as the deployment serves it,
    {projection: [nonzeros of each layer's pruned matrix]}): ``raw`` holds
    each projection's (L, in, out) weights; each layer's matrix is
    magnitude-pruned to ``sparsity``, then, where ``codes`` (a
    ``reference/codes`` module) is given, each of the family's pack
    ``groups`` is put in packed order and coded."""
    pruned = {n: torch.stack([magnitude_prune(w[l].float(), sparsity)
                              for l in range(w.shape[0])])
              for n, w in raw.items()}
    nnz = {n: [int(c) for c in (m != 0).sum(dim=(1, 2)).tolist()]
           for n, m in pruned.items()}
    if codes is None:
        return pruned, nnz
    out, inv_of = {}, {}
    for name, projs, _module, fuse, upstream in groups:
        halves = _group_rows_matrices(pruned, projs, fuse)
        perm, inv, buckets = _packed_order(halves, chunk_cols,
                                           inv_of.get(upstream))
        inv_of[name] = inv
        deq = codes.dequantize(halves, perm, buckets)
        if fuse == "halves":
            parts = dict(zip(projs, deq))
        else:
            sizes = [pruned[n].shape[2] for n in projs]
            parts = dict(zip(projs, torch.split(deq[0], sizes, dim=1)))
        for n, m in parts.items():
            out[n] = m.transpose(1, 2).contiguous()
    return out, nnz
