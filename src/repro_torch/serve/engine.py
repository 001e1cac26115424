"""Serving engine: paged KV cache + chunked prefill + scheduler (mirrors
``src/repro/serve/engine.py``).

Fixed B decode slots over one block-pool KV arena (``serve/paged_cache``).
Each tick is either one chunked-prefill call for a single slot
(``serve/prefill``) or one batched decode step across every decode-ready
slot; the interleave, admission order (FCFS / SJF) and per-request
latency metrics belong to ``serve/scheduler``.  With
``prefill_mode="replay"`` the prompt is fed through the decode step
instead, one token a tick (``"auto"`` picks chunked prefill where the
family has it; a sparse engine chunks only the dense family).

Two datapaths.  With ``sparse`` (from ``sparsify_model``) decode runs
every covered projection through the packed SpMV kernels across all
active slots at once, and prefill chunks run the same pruned matrices as
GEMMs.  With ``sparse=None`` the engine serves the dense model
(``serve_step_fn``: dense projections, a bf16 or int8 KV cache) — the
baseline the format is judged against.

Telemetry: every tick is traced (``engine.step`` spans with scheduler /
prefill / decode / host_sync / bookkeeping children; inside
``decode.launch`` and ``prefill.launch`` the forward's own spans, one a
layer group, which go to the process tracer, ``trace.get_tracer()``, as
``tracer`` does by default).  Spans bill the host's time in the device
trace's time base and never synchronise, so a device trace of the same
process says what the host was doing while the card idled.  The tick is
mirrored into a metrics registry (TTFT/TPOT/queue histograms,
terminal-state and fault counters, the paged cache's view rebuilds,
arena occupancy gauges, per-plane bytes/token and pad_frac gauges of the
packs).

Overload.  Admission reserves each request's worst-case block count
against the paged arena before a slot is taken; the wait queue may be
bounded with a shed policy (``reject`` / ``shed-oldest`` /
``shed-largest``: shed requests end ``shed`` and ``submit`` returns
False), and arena high/low watermarks pause admission with hysteresis.
Under arena pressure the engine preempts to recompute: the slot with the
most work left releases its blocks and re-enters the queue head, and
later resumes by re-feeding its prompt plus committed tokens — the
packs are static, so its remaining greedy tokens equal a never-preempted
run's.  The same replay gives ``snapshot()`` / ``restore()``
(``serve/snapshot.py``): the control plane is saved, KV is recomputed.

The fault ladder.  Packs are fingerprint-verified at construction: a
corrupted or mismatched pack raises ``PackIntegrityError``, or, with
``on_verify_failure="degrade"``, the whole engine serves the pruned dense
copy instead (``stats.degraded_to_dense``).  Every decode tick returns a
per-slot finite flag; a sparse slot whose logits are not finite is
quarantined alone (its KV write is dropped, nothing is emitted) and from
the next tick decodes the same position through a lazily built dense
step over ``pruned_param_tree`` — its request ends ``degraded``, with
the tokens the sparse path would have given under greedy decoding (both
closures of a tick sample from the tick's one generator state, so a
quarantine leaves the healthy slots' samples as they were at any
temperature).  A dense engine has no lower rung, so there a non-finite
slot ends ``failed``, as does a poisoned prefill on either path.
Per-request TTFT and wall-clock deadlines, ``cancel()``, capped-backoff
retry of ``TransientStepError`` and a ``LatencyWatchdog`` on the decode
loop complete the ladder.  Every exit funnels through one ``_teardown``
so no path can leak paged blocks; ``check_arena()`` (each step with
``validate_arena``) proves it.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import sparse_model
from repro_torch.core.integrity import PackIntegrityError
from repro_torch.device import resolve_device
from repro_torch.models import factory
from repro_torch.serve.paged_cache import make_kv_cache
from repro_torch.serve.prefill import ChunkedPrefiller
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.serve_step import (sample_tokens, serve_step_fn,
                                          serve_step_sparse_fn)
from repro_torch.telemetry import flightrec
from repro_torch.telemetry import metrics as tm
from repro_torch.telemetry import trace as tt

__all__ = ["Request", "EngineStats", "ServeEngine", "TransientStepError"]


class TransientStepError(RuntimeError):
    """A decode step failed for a reason worth retrying (device hiccup,
    injected fault).  The engine retries with capped exponential backoff;
    exhaustion tears the stepping slots down as ``failed`` instead of
    crashing the engine."""


def _finite_step(step):
    """Wrap a serve-step fn so it returns per-slot finite flags in place of
    the logits: (next tokens (B, 1), ok (B,) bool, new cache), both on the
    device — the guard costs the host one (B,) read per tick.  The guard
    is traced as ``finite_check``."""
    def fn(p, c, b):
        nxt, logits, cache = step(p, c, b)
        with tt.get_tracer().span("finite_check", cat="forward"):
            ok = torch.isfinite(logits.float()).all(dim=2).all(dim=1)
        return nxt, ok, cache
    return fn


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new_tokens: int = 16
    eos_id: int = -1  # -1: never stops early
    deadline_s: float | None = None       # total wall clock from submit
    ttft_deadline_s: float | None = None  # first token from submit
    output: list = dataclasses.field(default_factory=list)
    done: bool = False

    def worst_case_tokens(self, max_len: int) -> int:
        """Cache rows this request can ever occupy — the admission
        reservation and the submit-time feasibility check both use it."""
        return min(len(self.prompt) + self.max_new_tokens + 1, max_len)


@dataclasses.dataclass
class EngineStats:
    steps: int = 0                 # prefill + decode calls
    decode_steps: int = 0
    prefill_chunks: int = 0
    tokens_generated: int = 0
    requests_completed: int = 0    # full output: completed + degraded
    slot_occupancy: float = 0.0    # mean fraction of slots active per tick
    quarantines: int = 0           # per-slot non-finite guard trips
    retries: int = 0               # transient step failures retried
    preempts: int = 0              # slots released to recompute later
    requests_shed: int = 0         # dropped by overload admission control
    restored_requests: int = 0     # requests re-admitted by restore()
    watchdog_flags: int = 0        # LatencyWatchdog trips (stuck decode)
    degraded_tokens: int = 0       # tokens emitted by the dense fallback
    requests_degraded: int = 0     # completed, but via the dense fallback
    requests_cancelled: int = 0
    requests_deadline_expired: int = 0
    requests_failed: int = 0       # no datapath produced finite logits
    degraded_to_dense: bool = False  # whole engine fell back at load
    requests: list = dataclasses.field(default_factory=list)
    hists: dict | None = dataclasses.field(default=None, repr=False)

    def latency_summary(self) -> dict:
        from repro_torch.serve.scheduler import latency_summary
        return latency_summary(self.requests, hists=self.hists)


class _Slot:
    """Per-slot serving state (the request plus its progress)."""
    __slots__ = ("req", "metrics", "phase", "pos", "cursor", "cur_token",
                 "pf_cache", "degraded", "emitted_degraded", "feed",
                 "resumed")

    def __init__(self, req, metrics):
        self.req = req
        self.metrics = metrics
        self.phase = "prefill"     # "prefill" | "decode"
        self.pos = 0               # feed tokens prefilled (chunked mode)
        self.cursor = None         # replay cursor (replay mode)
        self.cur_token = 0
        self.pf_cache = None
        self.degraded = False          # decoding via the dense fallback
        self.emitted_degraded = False  # at least one fallback token out
        # tokens the prefill/replay phase feeds: the prompt for a fresh
        # request, prompt + committed output for a preempt/restore resume
        self.feed = req.prompt
        self.resumed = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: dict, batch_slots: int,
                 max_len: int, temperature: float = 0.0,
                 sparse: dict | None = None, impl: str | None = None, *,
                 device=None, paged: bool = True, block_size: int = 16,
                 num_blocks: int | None = None, prefill_chunk: int = 16,
                 prefill_mode: str = "auto", policy: str = "fcfs",
                 max_prefill_streak: int = 2, seed: int = 0,
                 verify_packs: bool = True, on_verify_failure: str = "raise",
                 max_retries: int = 2, retry_backoff: float = 0.05,
                 retry_backoff_cap: float = 1.0, watchdog=None,
                 validate_arena: bool = False, tracer: tt.Tracer | None = None,
                 metrics: tm.Registry | None = None, flight=None,
                 max_queue_depth: int | None = None,
                 shed_policy: str = "reject", preempt: bool = True,
                 watermark_high: float | None = None,
                 watermark_low: float | None = None):
        if on_verify_failure not in ("raise", "degrade"):
            raise ValueError(
                f"unknown on_verify_failure {on_verify_failure!r}; "
                "use 'raise' or 'degrade'")
        if prefill_mode not in ("auto", "chunked", "replay"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
        if watermark_high is not None:
            if watermark_low is None:
                watermark_low = max(0.0, watermark_high - 0.25)
            if not (0.0 <= watermark_low < watermark_high <= 1.0):
                raise ValueError(
                    f"watermarks need 0 <= low < high <= 1, got "
                    f"low={watermark_low} high={watermark_high}")
        factory.get_family(cfg)        # raises for an unknown family
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine was asked to run on {self.device}")
        # telemetry first, so load-time verification is observable
        self.tracer = tracer if tracer is not None else tt.get_tracer()
        self.flight = (flight if flight is not None
                       else flightrec.get_recorder())
        self.metrics = metrics if metrics is not None else tm.Registry({
            "model": cfg.name, "impl": impl or "default",
            "quant": (sparse or {}).get("quant", "none"),
            "attn": ("sparse" if (sparse or {}).get("attn_sparse")
                     else "dense")})
        self._c_verify_fail = self.metrics.counter(
            "serve_verify_failures_total",
            "pack integrity verifications that failed at engine load")
        # pack integrity gate first: a bit-flipped plane or a pack paired
        # with the wrong schedule never reaches a decode step — the load
        # fails, or the engine serves the pruned dense copy instead
        self.verified_packs: dict | None = None
        degraded_to_dense = False
        if sparse is not None and verify_packs:
            try:
                with self.tracer.span("pack.verify", cat="pack"):
                    self.verified_packs = sparse_model.verify_sparse(sparse)
            except PackIntegrityError:
                self._c_verify_fail.inc()
                if on_verify_failure != "degrade":
                    raise
                params = sparse_model.pruned_param_tree(params, sparse)
                sparse = None
                degraded_to_dense = True
        if sparse is not None and cfg.kv_cache_dtype == "int8":
            raise NotImplementedError(
                "the ESPIM decode path keeps a compute-dtype KV cache; the "
                "int8 KV cache serves the dense mode (sparse=None)")

        self.cfg = cfg
        self.params = params
        self.b = batch_slots
        self.max_len = max_len
        self.temperature = temperature
        self.sparse = sparse
        self.impl = impl
        self.cache = make_kv_cache(cfg, batch_slots, max_len, paged=paged,
                                   block_size=block_size,
                                   num_blocks=num_blocks, device=self.device)
        self.paged = paged
        self.slots: list[_Slot | None] = [None] * batch_slots
        self.seq_len = np.zeros(batch_slots, np.int32)
        self.scheduler = Scheduler(policy=policy,
                                   max_prefill_streak=max_prefill_streak,
                                   metrics=self.metrics,
                                   max_queue_depth=max_queue_depth,
                                   shed_policy=shed_policy,
                                   tracer=self.tracer, flight=self.flight)
        self.scheduler.on_shed = self._on_shed
        self.preempt = preempt
        self._wm_high = watermark_high
        self._wm_low = watermark_low
        self._backpressure = False
        self.stats = EngineStats(requests=self.scheduler.completed,
                                 degraded_to_dense=degraded_to_dense,
                                 hists=self.scheduler.hists)
        self._init_metrics(sparse)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._occ_accum = 0.0
        self.max_retries = max(0, max_retries)
        self.retry_backoff = retry_backoff
        self.retry_backoff_cap = retry_backoff_cap
        self.validate_arena = validate_arena
        self._watchdog = watchdog

        if prefill_mode == "auto":
            chunked = (factory.supports_chunked_prefill(cfg)
                       if sparse is None else cfg.family == "dense")
        else:
            chunked = prefill_mode == "chunked"
        self.chunked_prefill = chunked
        self._prefiller = None
        if chunked:
            self._prefiller = ChunkedPrefiller(
                cfg, prefill_chunk, max_len, self.cache.seq_names,
                self.cache.state_names, sparse=sparse, impl=impl,
                device=self.device)
        # a decode step may write its new K / V rows into the view it is
        # given only where that view is the cache's own copy (paged), never
        # the store itself (contiguous), which prefilling slots share
        self._donate = self.cache.view_is_private
        if sparse is None:
            self._decode = _finite_step(
                lambda p, c, b: serve_step_fn(cfg, p, c, b,
                                              temperature=temperature,
                                              generator=self._gen,
                                              donate=self._donate))
        else:
            self._decode = _finite_step(
                lambda p, c, b: serve_step_sparse_fn(
                    cfg, p, sparse, c, b, temperature=temperature,
                    impl=impl, generator=self._gen, device=self.device,
                    donate=self._donate))
        # the dense fallback of quarantined slots, built on first use over
        # the pruned dense copy of the same weights, so its greedy tokens
        # match the sparse path's: degraded is slower, never different
        self._dense_decode = None
        self._dense_params = None

    # ------------------------------------------------------------ telemetry
    def _init_metrics(self, sparse: dict | None) -> None:
        """Register the engine's instruments once and keep direct
        references (the hot path never does a registry lookup).  Static
        facts of the packs — bytes/token by plane, pad_frac by width
        bucket — are published as gauges here."""
        reg = self.metrics
        h = tm.LATENCY_BUCKETS_S
        self._h_step = {
            ph: reg.histogram("serve_step_seconds", buckets=h, phase=ph)
            for ph in ("prefill", "decode")}
        self._c_tokens = reg.counter(
            "serve_tokens_total", "tokens emitted, all datapaths")
        self._c_degraded_tokens = reg.counter(
            "serve_degraded_tokens_total", "tokens from the dense fallback")
        self._c_quarantines = reg.counter(
            "serve_quarantines_total", "per-slot non-finite guard trips")
        self._c_retries = reg.counter(
            "serve_retries_total", "transient step failures retried")
        self._c_watchdog = reg.counter(
            "serve_watchdog_flags_total", "stuck-decode watchdog trips")
        self._c_arena_checks = reg.counter(
            "serve_arena_checks_total", "leaked-block invariant sweeps run")
        self._c_preempts = reg.counter(
            "serve_preempts_total", "slots released to recompute later")
        self._c_shed = reg.counter(
            "serve_shed_total", "requests dropped by overload admission")
        self._c_restores = reg.counter(
            "serve_restores_total", "requests re-admitted from a snapshot")
        self._c_view_rebuilds = reg.counter(
            "serve_cache_view_rebuilds_total",
            "decode views rebuilt from the paged arena (block tables or "
            "pages changed since the last decode tick)")
        self._g_queue_depth = reg.gauge(
            "serve_queue_depth", "requests waiting for admission")
        self._g_headroom = reg.gauge(
            "serve_arena_headroom_blocks",
            "free arena blocks not covered by admission reservations")
        self._g_slot_occ = reg.gauge(
            "serve_slot_occupancy", "mean fraction of slots decoding")
        self._g_arena = {
            s: reg.gauge("serve_arena_blocks", state=s)
            for s in ("used", "free", "quarantined")}
        self._g_arena_occ = reg.gauge(
            "serve_arena_occupancy", "fraction of arena blocks in use")
        self._g_arena_frag = reg.gauge(
            "serve_arena_fragmentation",
            "1 - largest contiguous free run / free blocks")
        if sparse is None:
            return
        tot = sparse_model.sparse_stats(sparse)["total"]
        for plane, nbytes in (("value", tot["value_plane_bytes"]),
                              ("index", tot["index_plane_bytes"]),
                              ("dense", tot["dense_proj_bytes_per_token"])):
            reg.gauge("espim_bytes_per_token", plane=plane).set(nbytes)
        # pad_frac per width bucket, from the pack's own validity mask
        for gname, g in sparse["groups"].items():
            for i, (b, width) in enumerate(zip(g["buckets"], g["widths"])):
                valid = np.asarray(b["valid"])
                reg.gauge("espim_pad_frac", group=gname, bucket=str(i),
                          width=str(int(width))).set(
                    1.0 - float(valid.sum()) / max(1, valid.size))

    def _update_arena_gauges(self) -> None:
        self._g_queue_depth.set(self.scheduler.queue_depth)
        nb = getattr(self.cache, "num_blocks", 0)
        if not nb:
            return
        free = self.cache.free_blocks
        self._g_headroom.set(free - int(self.cache._resv.sum()))
        quarantined = len(self.cache._quarantined)
        self._g_arena["used"].set(nb - free - quarantined)
        self._g_arena["free"].set(free)
        self._g_arena["quarantined"].set(quarantined)
        self._g_arena_occ.set((nb - free - quarantined) / nb)
        # fragmentation: 1 - (largest contiguous free run / free blocks)
        if free:
            run = best = 1
            ids = sorted(self.cache._free)
            for a, b in zip(ids, ids[1:]):
                run = run + 1 if b == a + 1 else 1
                best = max(best, run)
            self._g_arena_frag.set(1.0 - best / free)
        else:
            self._g_arena_frag.set(0.0)

    # ------------------------------------------------------------ lifecycle
    def reset_stats(self) -> None:
        """Zero every counter and the per-request metrics (after a warm-up
        request, so a measurement sees steady state only)."""
        self.scheduler.completed.clear()
        self.scheduler.reset_metrics()
        self._occ_accum = 0.0
        self.stats = EngineStats(
            requests=self.scheduler.completed,
            degraded_to_dense=self.stats.degraded_to_dense,
            hists=self.scheduler.hists)

    def submit(self, req: Request) -> bool:
        """Enqueue a request.  Infeasible requests (cannot ever fit the
        arena or max_len) raise; a feasible one may still be shed by the
        bounded-queue policy — then it ends ``shed`` and this returns
        False.  Returns True when queued."""
        worst = req.worst_case_tokens(self.max_len)
        if self.paged and self.cache.blocks_needed(worst) > self.cache.num_blocks:
            raise ValueError(
                f"request {req.rid} needs {self.cache.blocks_needed(worst)} "
                f"blocks but the arena holds {self.cache.num_blocks}")
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"request {req.rid} prompt ({len(req.prompt)}) exceeds "
                f"max_len ({self.max_len})")
        admitted = self.scheduler.add(req) is not None
        self._g_queue_depth.set(self.scheduler.queue_depth)
        return admitted

    def _on_shed(self, req) -> None:
        """Scheduler shed hook: one request dropped by overload policy."""
        self.stats.requests_shed += 1
        self._c_shed.inc()
        info = {"rid": req.rid}
        self.tracer.instant("fault.shed", cat="fault", args=info)
        self.flight.record("fault", "fault.shed", info)
        if self.flight.pressure():
            self.flight.trip("shed_storm", registry=self.metrics)

    def cancel(self, rid: int) -> bool:
        """Cancel a request wherever it lives: an in-flight slot is torn
        down through the one teardown path, a queued request is retired
        by the scheduler.  Returns False for an unknown or finished
        rid."""
        for i, st in enumerate(self.slots):
            if st is not None and st.req.rid == rid:
                self._teardown(i, "cancelled")
                return True
        if self.scheduler.cancel_pending(rid):
            self.stats.requests_cancelled += 1
            return True
        return False

    def snapshot(self) -> dict:
        """Versioned, digest- and pack-fingerprint-bound serialization of
        the engine's control plane (queues, committed tokens, slot map).
        KV is recomputed on restore, never saved.  Call between
        ``step()`` calls."""
        from repro_torch.serve import snapshot as snapmod
        with self.tracer.span("snapshot.save", cat="snapshot") as sp:
            snap = snapmod.snapshot_engine(self)
            sp.set("requests", len(snap["requests"]))
        self.flight.record("snapshot", "snapshot.save",
                           {"requests": len(snap["requests"])})
        return snap

    def restore(self, snap: dict, requests: dict | None = None) -> list:
        """Re-admit every request of a snapshot into this idle engine; each
        resumes by re-feeding its committed history.  Raises
        ``SnapshotIntegrityError`` on a digest, version or pack mismatch.
        Returns the restored Request objects."""
        from repro_torch.serve import snapshot as snapmod
        with self.tracer.span("snapshot.restore", cat="snapshot") as sp:
            reqs = snapmod.restore_engine(self, snap, requests)
            sp.set("requests", len(reqs))
        self.flight.record("snapshot", "snapshot.restore",
                           {"requests": len(reqs)})
        return reqs

    def _arena_pressure(self) -> float:
        """Fraction of the arena used or spoken for (allocated +
        quarantined + outstanding reservations): the watermark signal."""
        nb = getattr(self.cache, "num_blocks", 0)
        if not nb:
            return 0.0
        used = nb - self.cache.free_blocks
        return (used + int(self.cache._resv.sum())) / nb

    def _admit(self) -> None:
        if self._wm_high is not None and self.paged:
            # hysteresis: past the high watermark admission pauses, and
            # resumes only once pressure falls to the low mark
            occ = self._arena_pressure()
            if self._backpressure:
                if occ <= self._wm_low:
                    self._backpressure = False
            elif occ >= self._wm_high:
                self._backpressure = True
            if self._backpressure:
                return
        for i in range(self.b):
            if self.slots[i] is not None:
                continue
            if not self.scheduler.has_pending:
                break

            def can_admit(r, slot=i):
                return self.cache.reserve(
                    slot, r.worst_case_tokens(self.max_len))

            picked = self.scheduler.pick(can_admit)
            if picked is None:
                break
            req, metrics = picked
            st = _Slot(req, metrics)
            adm = {"rid": req.rid, "slot": i, "resumed": bool(req.output)}
            self.tracer.instant("req.admit", cat="request", args=adm)
            self.flight.record("request", "req.admit", adm)
            self.seq_len[i] = 0
            # a request with committed output resumes (preempt/restore):
            # its KV is recomputed from prompt + committed tokens
            hist = list(req.prompt) + [int(t) for t in req.output]
            st.resumed = bool(req.output)
            if st.resumed:
                res = {"slot": i, "rid": req.rid,
                       "committed": len(req.output)}
                self.tracer.instant("fault.resume", cat="fault", args=res)
                self.flight.record("fault", "fault.resume", res)
            if self.chunked_prefill:
                st.phase = "prefill"
                st.pf_cache = self._prefiller.proto
                # the last committed token is the next decode's input, so
                # prefill re-feeds everything before it
                st.feed = hist[:-1] if st.resumed else hist
            else:
                st.phase = "decode"
                st.cursor = 0
                st.feed = hist
                st.cur_token = st.feed[0]
            self.slots[i] = st

    # ----------------------------------------------------------- preemption
    def _remaining_tokens(self, st: _Slot) -> int:
        """Tokens this slot still has to serve: unfed prefill/replay rows
        plus undecoded output — the longest-remaining-first victim key."""
        rem = st.req.max_new_tokens - len(st.req.output)
        if st.phase == "prefill":
            rem += len(st.feed) - st.pos
        elif st.cursor is not None and st.cursor < len(st.feed):
            rem += len(st.feed) - st.cursor
        return rem

    def _preempt_slot(self, i: int) -> _Slot:
        """Release one slot's KV blocks back to the pool, keeping the
        request's committed tokens for later recompute.  Not a terminal
        exit: the caller requeues the request."""
        st = self.slots[i]
        self.stats.preempts += 1
        self._c_preempts.inc()
        info = {"slot": i, "rid": st.req.rid,
                "committed": len(st.req.output)}
        self.tracer.instant("fault.preempt", cat="fault", args=info)
        self.flight.record("fault", "fault.preempt", info)
        if self.flight.pressure():
            self.flight.trip("preempt_storm", registry=self.metrics)
        self.cache.free_slot(i)
        self.slots[i] = None
        self.seq_len[i] = 0
        return st

    def _maybe_preempt(self) -> None:
        """Preempt to recompute: when the next queued request has a free
        slot waiting but is blocked on arena space, and some slot has
        strictly more work left than the candidate's whole footprint,
        release that slot (most remaining first), admit the candidate in
        the same tick and requeue the victim at the queue head.  The
        strict order makes chains terminate; slot shortage alone (arena
        fine) never preempts."""
        if (not self.preempt or not self.paged or self._backpressure
                or not self.scheduler.has_pending
                or all(s is not None for s in self.slots)):
            return
        cand = self.scheduler.peek()
        if cand is None:
            return
        req, _m = cand
        cand_rem = len(req.prompt) + req.max_new_tokens - len(req.output)
        victim, victim_rem = None, cand_rem
        for i, st in enumerate(self.slots):
            if st is None:
                continue
            rem = self._remaining_tokens(st)
            if rem > victim_rem:
                victim, victim_rem = i, rem
        if victim is None:
            return
        # evict only when the victim's blocks let the candidate reserve
        need = self.cache.blocks_needed(req.worst_case_tokens(self.max_len))
        avail = self.cache.free_blocks - int(self.cache._resv.sum())
        freed = (int(self.cache.n_blocks[victim])
                 + int(self.cache._resv[victim]))
        if avail + freed < need:
            return
        st = self._preempt_slot(victim)
        self._admit()                     # candidate takes the freed space
        self.scheduler.requeue(st.req, st.metrics)

    def _teardown(self, i: int, state: str = "completed") -> None:
        """The single exit path of every slot — finish, cancel, deadline,
        failure: releases its paged blocks and finalizes its scheduler
        state, so no exit can leak."""
        st = self.slots[i]
        if state == "completed" and st.emitted_degraded:
            state = "degraded"      # full output, but not all-sparse-path
        st.req.done = True
        self.scheduler.finish(st.metrics, state)
        if state == "failed":
            self.flight.trip("failure", registry=self.metrics)
        if state in ("completed", "degraded"):
            self.stats.requests_completed += 1
            if state == "degraded":
                self.stats.requests_degraded += 1
        elif state == "cancelled":
            self.stats.requests_cancelled += 1
        elif state == "deadline_expired":
            self.stats.requests_deadline_expired += 1
        else:
            self.stats.requests_failed += 1
        self.cache.free_slot(i)
        self.slots[i] = None
        self.seq_len[i] = 0

    def _expire(self) -> None:
        """Deadline sweep: queued requests past their limit are retired by
        the scheduler; in-flight slots past total wall clock (or past the
        TTFT deadline with no first token yet) are torn down."""
        now = time.monotonic()
        self.stats.requests_deadline_expired += len(
            self.scheduler.expire_pending(now))
        for i, st in enumerate(self.slots):
            if st is None:
                continue
            dl = st.req.deadline_s
            if dl is not None and now - st.metrics.t_submit > dl:
                self._teardown(i, "deadline_expired")
                continue
            tdl = st.req.ttft_deadline_s
            if (tdl is not None and st.metrics.t_first is None
                    and now - st.metrics.t_submit > tdl):
                self._teardown(i, "deadline_expired")

    def _quarantine(self, i: int, phase: str) -> None:
        """Count and record one slot's non-finite guard trip."""
        self.stats.quarantines += 1
        self._c_quarantines.inc()
        q = {"slot": i, "rid": self.slots[i].req.rid, "phase": phase}
        self.tracer.instant("fault.quarantine", cat="fault", args=q)
        self.flight.record("fault", "fault.quarantine", q)
        self.flight.trip("quarantine", registry=self.metrics)

    def _dense_fallback(self):
        """The dense decode over the pruned dense copy of the sparse
        weights — built on first quarantine, shared by every degraded slot
        after."""
        if self._dense_decode is None:
            self._dense_params = sparse_model.pruned_param_tree(
                self.params, self.sparse)
            cfg, temperature = self.cfg, self.temperature
            self._dense_decode = _finite_step(
                lambda p, c, b: serve_step_fn(cfg, p, c, b,
                                              temperature=temperature,
                                              generator=self._gen,
                                              donate=self._donate))
        return self._dense_decode, self._dense_params

    def _retry(self, fn, *args):
        """Run one step, retrying transient failures with capped
        exponential backoff; re-raises after ``max_retries`` retries."""
        delay = self.retry_backoff
        for attempt in range(self.max_retries + 1):
            try:
                return fn(*args)
            except TransientStepError:
                if attempt >= self.max_retries:
                    raise
                self.stats.retries += 1
                self._c_retries.inc()
                info = {"attempt": attempt, "backoff_s": delay}
                self.tracer.instant("fault.retry", cat="fault", args=info)
                self.flight.record("fault", "fault.retry", info)
                time.sleep(delay)
                delay = min(delay * 2.0, self.retry_backoff_cap)

    def check_arena(self) -> dict:
        """Arena invariant after any step: every physical block in exactly
        one owner, and empty slots own nothing.  Raises on violation."""
        self._c_arena_checks.inc()
        acct = self.cache.arena_check()
        n_blocks = getattr(self.cache, "n_blocks", None)
        if n_blocks is not None:
            for i, st in enumerate(self.slots):
                if st is None and int(n_blocks[i]) != 0:
                    raise RuntimeError(
                        f"empty slot {i} still owns {int(n_blocks[i])} "
                        f"paged blocks — teardown leak")
        return acct

    def _emit_token(self, i: int, tok: int) -> None:
        st = self.slots[i]
        if st.metrics.t_first is None:
            st.metrics.t_first = time.monotonic()
            ft = {"rid": st.req.rid, "slot": i}
            self.tracer.instant("req.first_token", cat="request", args=ft)
            self.flight.record("request", "req.first_token", ft)
        st.req.output.append(tok)
        st.metrics.n_out += 1
        self.stats.tokens_generated += 1
        self._c_tokens.inc()
        st.cur_token = tok
        seq_len = len(st.req.prompt) + len(st.req.output)
        if (tok == st.req.eos_id
                or len(st.req.output) >= st.req.max_new_tokens
                or seq_len >= self.max_len - 1):
            self._teardown(i)

    # ----------------------------------------------------------- tick kinds
    def _prefill_tick(self, i: int) -> None:
        st = self.slots[i]
        plen = len(st.feed)
        with self.tracer.span("prefill.launch", cat="prefill") as sp:
            sp.set("slot", i).set("pos", st.pos)
            logits, st.pf_cache, n_valid = self._prefiller.run_chunk(
                self.params, st.pf_cache, st.feed, st.pos)
        with self.tracer.span("cache.scatter", cat="prefill"):
            self.cache.ensure(i, st.pos + n_valid)
            self.cache.scatter_chunk(
                i, self._prefiller.chunk_rows(st.pf_cache, st.pos),
                st.pos, n_valid)
        st.pos += n_valid
        self.stats.steps += 1
        self.stats.prefill_chunks += 1
        if st.pos < plen:
            return
        # install the recurrent states (a failed slot's teardown zeroes
        # them again)
        self.cache.set_slot_state(i, self._prefiller.state_rows(st.pf_cache))
        st.pf_cache = None
        self.seq_len[i] = plen
        st.phase = "decode"
        if st.resumed:
            # resume recompute: the feed ends just before the last
            # committed token, which becomes the next decode input — the
            # final chunk's logits are history, never re-sampled
            st.cur_token = int(st.req.output[-1])
            return
        # prompt fully prefilled: sample the first token from the final
        # chunk's logits
        with self.tracer.span("host.sample", cat="host_sync"):
            last = logits[:, n_valid - 1]
            tok = sample_tokens(self.cfg, last, self.temperature, self._gen)
            finite = bool(torch.isfinite(last.float()).all())
            tok = int(tok[0])
        if not finite:
            # a poisoned prefill has contaminated this slot's KV history:
            # no fallback can recompute it, so the slot ends here rather
            # than emit a wrong token
            self._quarantine(i, "prefill")
            self._teardown(i, "failed")
            return
        self._emit_token(i, tok)

    def _launch(self, fn, params, view, batch, span: str):
        """One decode closure over the shared view, transient failures
        retried -> (host next tokens (B,), host finite flags (B,), new
        cache); one device-to-host read."""
        with self.tracer.span(span, cat="decode"):
            nxt, ok, new_cache = self._retry(fn, params, view, batch)
        with self.tracer.span("host.sync", cat="host_sync"):
            both = torch.cat([nxt[:, 0].to(torch.int32),
                              ok.to(torch.int32)]).cpu().numpy()
        return both[:self.b], both[self.b:].astype(bool), new_cache

    def _decode_tick(self, decoding: list[int]) -> None:
        with self.tracer.span("decode.prepare", cat="decode"):
            cur = np.zeros((self.b, 1), np.int32)
            lens = np.zeros(self.b, np.int32)
            for i in decoding:
                st = self.slots[i]
                if st.cursor is not None and st.cursor < len(st.feed):
                    cur[i, 0] = st.feed[st.cursor]   # replay prefill/resume
                else:
                    cur[i, 0] = st.cur_token
                lens[i] = self.seq_len[i]
                self.cache.ensure(i, int(self.seq_len[i]) + 1)
            healthy = [i for i in decoding if not self.slots[i].degraded]
            degraded = [i for i in decoding if self.slots[i].degraded]
        with self.tracer.span("cache.gather", cat="decode"):
            rebuilds = self.cache.view_rebuilds
            view = self.cache.gather_view(lens)
            self._c_view_rebuilds.inc(self.cache.view_rebuilds - rebuilds)
            batch = {"tokens": torch.as_tensor(cur, device=self.device)}
        # both closures sample from the tick's one generator state, as the
        # reference's closures share the tick's batch["rng"]
        rng_state = self._gen.get_state() if healthy and degraded else None
        t0 = time.monotonic()
        results: dict[int, int] = {}   # slot -> sampled token this tick
        n_applies = 0
        any_drop = False

        def _commit(ok, new_cache, group):
            # commit only the group's finite slots: a poisoned row is
            # dropped at the arena, and the slot's position is decoded
            # again by the dense fallback next tick
            nonlocal n_applies
            commit = np.zeros(self.b, bool)
            commit[group] = ok[group]
            with self.tracer.span("cache.scatter", cat="decode"):
                self.cache.apply_decode(new_cache, lens, commit)
            n_applies += 1

        if healthy:
            try:
                nxt, ok, new_cache = self._launch(
                    self._decode, self.params, view, batch, "decode.launch")
            except TransientStepError:
                for i in healthy:
                    self._teardown(i, "failed")
            else:
                _commit(ok, new_cache, healthy)
                for i in healthy:
                    if ok[i]:
                        results[i] = int(nxt[i])
                        continue
                    any_drop = True
                    self._quarantine(i, "decode")
                    if self.sparse is None:
                        # dense engine: no lower rung on the ladder
                        self._teardown(i, "failed")
                    else:
                        # no emit, no advance: next tick this slot decodes
                        # the same position densely
                        self.slots[i].degraded = True

        degraded = [i for i in degraded if self.slots[i] is not None]
        if degraded:
            if rng_state is not None:
                self._gen.set_state(rng_state)
            fn, dparams = self._dense_fallback()
            try:
                nxt, ok, new_cache = self._launch(
                    fn, dparams, view, batch, "decode.launch_degraded")
            except TransientStepError:
                for i in degraded:
                    self._teardown(i, "failed")
            else:
                _commit(ok, new_cache, degraded)
                for i in degraded:
                    if ok[i]:
                        results[i] = int(nxt[i])
                    else:
                        # dense gave no finite logits either: the poison
                        # is in this slot's history, not the sparse weights
                        any_drop = True
                        self._teardown(i, "failed")

        if n_applies != 1 or any_drop:
            # two closures, a dropped write or a failed launch left a
            # partial cached view behind: the next gather rebuilds from
            # the pages
            self.cache.invalidate_view()
        self.stats.steps += 1
        self.stats.decode_steps += 1
        self._occ_accum += len(decoding) / self.b
        self.stats.slot_occupancy = self._occ_accum / self.stats.decode_steps
        self._g_slot_occ.set(self.stats.slot_occupancy)
        if (self._watchdog is not None
                and self._watchdog.observe(time.monotonic() - t0)):
            self.stats.watchdog_flags += 1
            self._c_watchdog.inc()
            self.tracer.instant("fault.watchdog_flag", cat="fault")
            self.flight.record("fault", "fault.watchdog_flag", None)

        with self.tracer.span("decode.emit", cat="decode"):
            for i in decoding:
                st = self.slots[i]
                if st is None or i not in results:
                    continue  # torn down or quarantined: no emit/advance
                self.seq_len[i] += 1
                if st.cursor is not None and st.cursor < len(st.feed):
                    st.cursor += 1
                    if st.cursor < len(st.feed):
                        continue        # still replaying: output ignored
                if st.degraded:
                    st.emitted_degraded = True
                    self.stats.degraded_tokens += 1
                    self._c_degraded_tokens.inc()
                self._emit_token(i, results[i])

    # ------------------------------------------------------------- stepping
    def step(self) -> None:
        """One engine tick: a prefill chunk for one slot, or one decode
        step across all decode-ready slots.  Traced as one ``engine.step``
        span whose direct children are the per-phase breakdown."""
        with self.tracer.span("engine.step", cat="engine"):
            with self.tracer.span("scheduler.expire", cat="scheduler"):
                self._expire()
            with self.tracer.span("scheduler.admit", cat="scheduler"):
                self._admit()
                self._maybe_preempt()
            with self.tracer.span("scheduler.plan", cat="scheduler"):
                prefilling = [i for i, s in enumerate(self.slots)
                              if s is not None and s.phase == "prefill"]
                decoding = [i for i, s in enumerate(self.slots)
                            if s is not None and s.phase == "decode"]
                action, target = self.scheduler.next_action(prefilling,
                                                            decoding)
            if action == "prefill":
                t0 = time.monotonic()
                # work spans carry their request(s), so
                # ``build_timelines`` can attribute every tick to a rid
                st = self.slots[target]
                pf_args = {"rid": st.req.rid, "slot": target,
                           "tokens": self._prefiller.n_valid(st.feed,
                                                             st.pos)}
                self.flight.record("step", "prefill.chunk", pf_args)
                with self.tracer.span("prefill.chunk", cat="prefill",
                                      args=pf_args):
                    self._prefill_tick(target)
                self._h_step["prefill"].observe(time.monotonic() - t0)
            elif action == "decode":
                t0 = time.monotonic()
                d_args = {"rids": [self.slots[i].req.rid
                                   for i in decoding]}
                self.flight.record("step", "decode.step", d_args)
                with self.tracer.span("decode.step", cat="decode",
                                      args=d_args):
                    self._decode_tick(decoding)
                self._h_step["decode"].observe(time.monotonic() - t0)
            with self.tracer.span("metrics.update", cat="scheduler"):
                if self.validate_arena:
                    self.check_arena()
                self._update_arena_gauges()

    def run(self, max_steps: int = 10_000) -> EngineStats:
        with self.tracer.span("engine.run", cat="engine"):
            for _ in range(max_steps):
                if (not self.scheduler.has_pending
                        and all(s is None for s in self.slots)):
                    break
                self.step()
        return self.stats
