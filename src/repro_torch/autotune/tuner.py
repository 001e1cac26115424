"""Candidate ranking + measured search for SDDS kernel schedules on
Hopper (the port's twin of the JAX package's ``autotune/tuner.py``).

The pipeline: enumerate the legal schedule space for the pack's shape
(``core.sdds.enumerate_schedules``: chunk width x warps a row x U),
deduplicate candidates that launch identically for the chosen impl
(``ref`` reads only the chunk width; on the card a ``warps_per_row`` of
0 is the default's own value for a chunked pack), rank all of them with
the cost model below, time only the ``max_candidates`` cheapest with
``telemetry.profile.time_launch`` on the real uploaded planes (on the
device clock for CUDA planes), and keep the measured winner.

Cost model — three transparent terms in microseconds, no fitted
constants:

* **traffic**: the bytes the launch must move — value plane (narrowed by
  the quant mode) and index plane over the pack's nonzeros, inflated by
  the candidate's chunk pad fraction (pad slots are streamed like any
  other), plus x and the output — at the card's HBM rate;
* **launch**: a fixed cost a launch (one per candidate);
* **under-fill**: a launch whose rows x warps a row are fewer than the
  SMs' resident warps streams at that fraction of the rate, so the
  traffic term is divided by it.

U (groups in flight a lane) does not enter the model: candidates that
differ only in U tie, keep their enumeration order, and are told apart
by the measurement.

``search_stats`` counts candidate benchmarks performed; the warm-cache
contract (a second tune of an identical pack performs ZERO candidate
benchmarks) is asserted against it in the tests and ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.autotune.cache import PlanCache, pack_cache_key
from repro_torch.core.sdds import (DEFAULT_SCHEDULE, KernelSchedule,
                                   enumerate_schedules, fill_warps_per_row)
from repro_torch.core.sparse_format import ELLPack, chunk_pack
from repro_torch.device import resolve_device
from repro_torch.telemetry.profile import time_launch

__all__ = ["TunedPlan", "autotune_pack", "schedule_cost", "search_stats",
           "reset_search_stats", "HBM_BYTES_PER_S", "LAUNCH_US", "SMS",
           "RESIDENT_WARPS"]

# H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s, 132 SMs
HBM_BYTES_PER_S = 3.35e12
SMS = 132
# PERF.md §5 (chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W): a
# launch of 384-1800 rows takes 7-12 µs whatever its bytes; the low end
LAUNCH_US = 7.0
# ptxas: the streaming kernel uses 40-54 registers a thread at 128
# threads a block, so 10 blocks (40 warps) fit an SM's 65,536 registers
RESIDENT_WARPS = 40

search_stats = {"searches": 0, "benchmarks": 0, "hits": 0, "misses": 0}


def reset_search_stats() -> None:
    for k in search_stats:
        search_stats[k] = 0


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """The autotuner's verdict for one (pack, launch context).

    ``source`` records how the plan was obtained — ``"search"`` (measured
    now), ``"cache"`` (fingerprint-keyed hit, zero benchmarks) or
    ``"default"`` (nothing legal to search) — and rides into
    ``Provenance.schedule`` so results distinguish tuned runs.
    """

    schedule: KernelSchedule
    source: str                    # "search" | "cache" | "default"
    key: str
    best_us: float | None = None
    candidates: int = 0            # benchmarks performed for this plan

    def to_provenance(self) -> dict:
        return {
            "source": self.source,
            "tuned": self.source != "default",
            "cache_key": self.key,
            "chunk_cols": self.schedule.chunk_cols,
            "warps_per_row": self.schedule.warps_per_row,
            "u": self.schedule.u,
            "best_us": self.best_us,
            "candidates": self.candidates,
        }


def _value_bytes(quant) -> float:
    bits = getattr(quant, "bits", None)
    if bits is None and isinstance(quant, str):
        bits = {"int8": 8, "int4": 4}.get(quant)
    return {8: 1.0, 4: 0.5}.get(bits, 4.0)


def schedule_cost(s: KernelSchedule, *, rows: int, nnz: int, n_cols: int,
                  b: int, quant=None, pad_frac: float = 0.0,
                  sms: int = SMS) -> float:
    """Rank-only cost of launching ``s`` in microseconds (lower is
    better): traffic at the HBM rate over the fill fraction, plus one
    launch.  ``rows`` is the launch's row count, ``nnz`` the pack's
    nonzeros, ``pad_frac`` the chunked layout's pad share of its slots."""
    plane = nnz * (_value_bytes(quant) + 4.0) / max(1.0 - pad_frac, 1e-9)
    traffic = plane + n_cols * b * 4.0 + rows * b * 4.0
    slots = nnz / max(rows, 1) / max(1.0 - pad_frac, 1e-9)
    wpr = s.warps_per_row or fill_warps_per_row(int(slots))
    fill = min(1.0, rows * wpr / (sms * RESIDENT_WARPS))
    return traffic / HBM_BYTES_PER_S * 1e6 / max(fill, 1e-9) + LAUNCH_US


def _quant_name(quant) -> str | None:
    if quant is None:
        return None
    if isinstance(quant, str):
        return quant
    return {8: "int8", 4: "int4"}.get(getattr(quant, "bits", None))


def _chunked_for(pack, cc: int, chunk_cache: dict):
    if cc not in chunk_cache:
        chunk_cache[cc] = (chunk_pack(pack, cc)
                           if isinstance(pack, ELLPack) else pack)
    return chunk_cache[cc]


def _launch_fn(cp, x, s: KernelSchedule, impl: str, quant):
    """The benchmarked closure: the SAME ops-layer call the serving path
    makes, with the candidate schedule applied.  The planes are uploaded
    here, outside the timed region."""
    from repro_torch.kernels import ops
    dev = x.device
    cols = torch.tensor(cp.cols, dtype=torch.int32, device=dev)
    if quant is None:
        vals = torch.tensor(cp.values, dtype=torch.float32, device=dev)

        def fn():
            return ops.espim_spmv_batched(
                vals, cols, x, chunk_cols=cp.chunk_cols, impl=impl,
                schedule=s)
    else:
        from repro_torch.quant import QuantSpec, default_spec, quantize_pack
        spec = quant if isinstance(quant, QuantSpec) else default_spec(quant)
        plane = cp.qplane
        if plane is None or plane.spec != spec:
            plane = quantize_pack(cp, spec)
        codes = torch.tensor(plane.device_codes(), device=dev)
        scales = torch.tensor(plane.scales, device=dev)
        group_rows = plane.group_rows

        def fn():
            return ops.espim_spmv_batched_quant(
                codes, cols, scales, x, chunk_cols=cp.chunk_cols,
                group_rows=group_rows, impl=impl, schedule=s)
    return fn


def _resolve_impl(impl: str | None, dev: torch.device) -> str:
    """``ref`` or ``cuda``: the ``ESPIM_IMPL`` pin, else ``impl``, else
    the device's; ``cuda`` on a CPU device raises."""
    from repro_torch.kernels import ops
    impl = ops._resolve(impl)
    if impl is None:
        impl = "cuda" if dev.type == "cuda" else "ref"
    if impl == "cuda" and dev.type != "cuda":
        raise ValueError("impl='cuda' needs a CUDA device; tune on the CPU "
                         "with impl='ref' (or None)")
    return impl


def autotune_pack(pack, *, b: int = 8, quant=None, impl: str | None = None,
                  cache: PlanCache | None = None,
                  max_candidates: int = 3, iters: int = 3,
                  warmup: int = 1, device=None) -> TunedPlan:
    """Pick a kernel schedule for ``pack`` under the given launch context,
    timing candidates on ``device`` (default cuda; raises without one
    unless asked for the CPU, where ``impl`` resolves to ``ref``).

    ``pack`` is a plain ``ELLPack`` (full search: the chunk pass is part
    of the schedule) or an ``ELLChunkedPack`` (``chunk_cols`` pinned by
    the artifact; warps a row and U only).  ``cache`` short-circuits the
    whole search on a fingerprint hit; its key holds the planes' device
    type as ``backend``, so a plan tuned on the CPU never serves a CUDA
    launch.  ``max_candidates`` bounds how many cost-ranked candidates
    are actually timed.
    """
    dev = resolve_device(device)
    impl = _resolve_impl(impl, dev)
    qname = _quant_name(quant)
    key = pack_cache_key(pack, b=b, quant=qname, impl=impl,
                         backend=dev.type)

    if cache is not None:
        entry = cache.get(key)
        if entry is not None:
            search_stats["hits"] += 1
            return TunedPlan(schedule=KernelSchedule(**entry["schedule"]),
                             source="cache", key=key,
                             best_us=entry.get("best_us"),
                             candidates=0)
        search_stats["misses"] += 1

    search_stats["searches"] += 1
    rows, n_cols = pack.r_pad, pack.n_cols
    if isinstance(pack, ELLPack):
        cands = enumerate_schedules(n_cols=n_cols)
    else:
        pinned = dataclasses.replace(DEFAULT_SCHEDULE,
                                     chunk_cols=pack.chunk_cols)
        cands = [pinned] + [
            s for s in enumerate_schedules(
                n_cols=n_cols, chunk_cols_options=(pack.chunk_cols,))
            if s.chunk_cols == pack.chunk_cols and s != pinned]
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else SMS)
    # a chunked pack's padded slots a row set the launcher's default warps
    # a row; a plain pack's depend on each candidate's chunk width
    slots = (int(np.prod(np.shape(pack.cols)[1:]))
             if not isinstance(pack, ELLPack) else None)
    seen: set = set()
    deduped = []
    for s in cands:
        eff = s
        if impl == "cuda" and s.warps_per_row == 0 and slots is not None:
            eff = dataclasses.replace(
                s, warps_per_row=fill_warps_per_row(slots))
        ek = eff.effective_key(impl)
        if ek not in seen:
            seen.add(ek)
            deduped.append(s)
    if not deduped:
        return TunedPlan(schedule=DEFAULT_SCHEDULE, source="default",
                         key=key)

    chunk_cache: dict = {}
    ranked = []
    for i, s in enumerate(deduped):
        cp = _chunked_for(pack, s.chunk_cols, chunk_cache)
        ranked.append((schedule_cost(
            s, rows=rows, nnz=cp.plan.nnz, n_cols=n_cols, b=b, quant=quant,
            pad_frac=cp.plan.chunk_pad_frac, sms=sms), i, s))
    ranked.sort(key=lambda t: t[:2])
    top = [s for _, _, s in ranked[:max(1, max_candidates)]]

    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((n_cols, b)), dtype=torch.float32,
                     device=dev)
    best = None
    for s in top:
        cp = _chunked_for(pack, s.chunk_cols, chunk_cache)
        fn = _launch_fn(cp, x, s, impl, quant)
        t = time_launch(fn, iters=iters, warmup=warmup,
                        label=f"autotune.{s.chunk_cols}.{s.warps_per_row}."
                              f"{s.u}")
        search_stats["benchmarks"] += 1
        if best is None or t.best_us < best[0]:
            best = (t.best_us, s)

    plan = TunedPlan(schedule=best[1], source="search", key=key,
                     best_us=best[0], candidates=len(top))
    if cache is not None:
        cache.put(key, {"schedule": dataclasses.asdict(plan.schedule),
                        "best_us": plan.best_us,
                        "candidates": plan.candidates,
                        "created_by": "search"})
    return plan
