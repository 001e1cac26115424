"""Serving engine: paged KV cache + chunked prefill + scheduler (mirrors
``src/repro/serve/engine.py``).

Fixed B decode slots over one block-pool KV arena (``serve/paged_cache``).
Each tick is either one chunked-prefill call for a single slot
(``serve/prefill``) or one batched decode step across every decode-ready
slot; the interleave, admission order (FCFS / SJF) and per-request
latency metrics belong to ``serve/scheduler``.

Two datapaths.  With ``sparse`` (from ``sparsify_model``) decode runs
every covered projection through the packed SpMV kernels across all
active slots at once, and prefill chunks run the same pruned matrices as
GEMMs.  With ``sparse=None`` the engine serves the dense model
(``serve_step_fn``: dense projections, a bf16 or int8 KV cache) — the
baseline the format is judged against.

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
temperature).  A dense engine has no lower
rung, so there a non-finite slot ends ``failed``, as does a poisoned
prefill on either path.  Every exit funnels through one ``_teardown`` so
no path can leak paged blocks; ``check_arena()`` proves it.

Not ported yet (ROADMAP Queue 1, "Robustness"): retries, the watchdog,
deadlines, cancel, preemption, watermarks, the fault drills
(``serve/faults.py``), snapshot and restore, and token-replay prefill
(``prefill_mode="replay"``, for families without chunked prefill).
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

__all__ = ["Request", "EngineStats", "ServeEngine"]


def _finite_step(step):
    """Wrap a serve-step fn so it returns per-slot finite flags in place of
    the logits: (next tokens (B, 1), ok (B,) bool, new cache), both on the
    device — the guard costs the host one (B,) read per tick."""
    def fn(p, c, b):
        nxt, logits, cache = step(p, c, b)
        ok = torch.isfinite(logits.float()).all(dim=2).all(dim=1)
        return nxt, ok, cache
    return fn


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new_tokens: int = 16
    eos_id: int = -1  # -1: never stops early
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
    degraded_tokens: int = 0       # tokens emitted by the dense fallback
    requests_degraded: int = 0     # completed, but via the dense fallback
    requests_failed: int = 0       # no datapath produced finite logits
    degraded_to_dense: bool = False  # whole engine fell back at load
    requests: list = dataclasses.field(default_factory=list)
    hists: dict | None = dataclasses.field(default=None, repr=False)

    def latency_summary(self) -> dict:
        from repro_torch.serve.scheduler import latency_summary
        return latency_summary(self.requests, hists=self.hists)


class _Slot:
    """Per-slot serving state (the request plus its progress)."""
    __slots__ = ("req", "metrics", "phase", "pos", "cur_token", "pf_cache",
                 "degraded", "emitted_degraded")

    def __init__(self, req, metrics):
        self.req = req
        self.metrics = metrics
        self.phase = "prefill"     # "prefill" | "decode"
        self.pos = 0               # prompt tokens prefilled
        self.cur_token = 0
        self.pf_cache = None
        self.degraded = False          # decoding via the dense fallback
        self.emitted_degraded = False  # at least one fallback token out


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: dict, batch_slots: int,
                 max_len: int, sparse: dict | None = None,
                 impl: str | None = None, device=None, *,
                 paged: bool = True, block_size: int = 16,
                 num_blocks: int | None = None, prefill_chunk: int = 16,
                 policy: str = "fcfs", max_prefill_streak: int = 2,
                 temperature: float = 0.0, seed: int = 0,
                 on_verify_failure: str = "raise"):
        if on_verify_failure not in ("raise", "degrade"):
            raise ValueError(
                f"unknown on_verify_failure {on_verify_failure!r}; "
                "use 'raise' or 'degrade'")
        # the reference's prefill_mode="auto": chunked where the family
        # has it (get_family raises for a family not ported)
        if not factory.supports_chunked_prefill(cfg):
            raise NotImplementedError(
                "token-replay prefill is not ported (ROADMAP Queue 1, "
                "'Robustness')")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine was asked to run on {self.device}")
        self.tracer = tt.get_tracer()
        self.flight = flightrec.get_recorder()
        self.metrics = tm.Registry({
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
        if sparse is not None:
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
                                   metrics=self.metrics, tracer=self.tracer,
                                   flight=self.flight)
        self.stats = EngineStats(requests=self.scheduler.completed,
                                 degraded_to_dense=degraded_to_dense,
                                 hists=self.scheduler.hists)
        self._h_step = {
            ph: self.metrics.histogram("serve_step_seconds",
                                       buckets=tm.LATENCY_BUCKETS_S,
                                       phase=ph)
            for ph in ("prefill", "decode")}
        self._c_tokens = self.metrics.counter(
            "serve_tokens_total", "tokens emitted, all datapaths")
        self._c_degraded_tokens = self.metrics.counter(
            "serve_degraded_tokens_total", "tokens from the dense fallback")
        self._c_quarantines = self.metrics.counter(
            "serve_quarantines_total", "per-slot non-finite guard trips")
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._occ_accum = 0.0
        self._prefiller = ChunkedPrefiller(
            cfg, prefill_chunk, max_len, self.cache.seq_names,
            sparse=sparse, impl=impl, device=self.device)
        if sparse is None:
            self._decode = _finite_step(
                lambda p, c, b: serve_step_fn(cfg, p, c, b,
                                              temperature=temperature,
                                              generator=self._gen))
        else:
            self._decode = _finite_step(
                lambda p, c, b: serve_step_sparse_fn(
                    cfg, p, sparse, c, b, temperature=temperature,
                    impl=impl, generator=self._gen, device=self.device))
        # the dense fallback of quarantined slots, built on first use over
        # the pruned dense copy of the same weights, so its greedy tokens
        # match the sparse path's: degraded is slower, never different
        self._dense_decode = None
        self._dense_params = None

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
        """Enqueue a request; infeasible requests (cannot ever fit the
        arena or max_len) raise.  Returns True when queued."""
        worst = req.worst_case_tokens(self.max_len)
        if self.paged and self.cache.blocks_needed(worst) > self.cache.num_blocks:
            raise ValueError(
                f"request {req.rid} needs {self.cache.blocks_needed(worst)} "
                f"blocks but the arena holds {self.cache.num_blocks}")
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"request {req.rid} prompt ({len(req.prompt)}) exceeds "
                f"max_len ({self.max_len})")
        return self.scheduler.add(req) is not None

    def _admit(self) -> None:
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
            adm = {"rid": req.rid, "slot": i}
            self.tracer.instant("req.admit", cat="request", args=adm)
            self.flight.record("request", "req.admit", adm)
            self.seq_len[i] = 0
            st.pf_cache = self._prefiller.proto
            self.slots[i] = st

    def _teardown(self, i: int, state: str = "completed") -> None:
        """The single exit path of every slot: releases its paged blocks
        and finalizes its scheduler state, so no exit can leak."""
        st = self.slots[i]
        if state == "completed" and st.emitted_degraded:
            state = "degraded"      # full output, but not all-sparse-path
        st.req.done = True
        self.scheduler.finish(st.metrics, state)
        if state in ("completed", "degraded"):
            self.stats.requests_completed += 1
            if state == "degraded":
                self.stats.requests_degraded += 1
        else:
            self.stats.requests_failed += 1
            self.flight.trip("failure", registry=self.metrics)
        self.cache.free_slot(i)
        self.slots[i] = None
        self.seq_len[i] = 0

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
                                              generator=self._gen))
        return self._dense_decode, self._dense_params

    def check_arena(self) -> dict:
        """Arena invariant after any step: every physical block in exactly
        one owner, and empty slots own nothing.  Raises on violation."""
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
        plen = len(st.req.prompt)
        with self.tracer.span("prefill.launch", cat="prefill") as sp:
            sp.set("slot", i).set("pos", st.pos)
            logits, st.pf_cache, n_valid = self._prefiller.run_chunk(
                self.params, st.pf_cache, st.req.prompt, st.pos)
            self.tracer.fence(logits)
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
        st.pf_cache = None
        self.seq_len[i] = plen
        st.phase = "decode"
        self._emit_token(i, tok)

    def _launch(self, fn, params, view, batch, span: str):
        """One decode closure over the shared view -> (host next tokens
        (B,), host finite flags (B,), new cache); one device-to-host
        read."""
        with self.tracer.span(span, cat="decode"):
            nxt, ok, new_cache = fn(params, view, batch)
        with self.tracer.span("host.sync", cat="host_sync"):
            both = torch.cat([nxt[:, 0].to(torch.int32),
                              ok.to(torch.int32)]).cpu().numpy()
        return both[:self.b], both[self.b:].astype(bool), new_cache

    def _decode_tick(self, decoding: list[int]) -> None:
        with self.tracer.span("decode.prepare", cat="decode"):
            cur = np.zeros((self.b, 1), np.int32)
            lens = np.zeros(self.b, np.int32)
            for i in decoding:
                cur[i, 0] = self.slots[i].cur_token
                lens[i] = self.seq_len[i]
                self.cache.ensure(i, int(self.seq_len[i]) + 1)
            healthy = [i for i in decoding if not self.slots[i].degraded]
            degraded = [i for i in decoding if self.slots[i].degraded]
        with self.tracer.span("cache.gather", cat="decode"):
            view = self.cache.gather_view(lens)
            batch = {"tokens": torch.as_tensor(cur, device=self.device)}
        # both closures sample from the tick's one generator state, as the
        # reference's closures share the tick's batch["rng"]
        rng_state = self._gen.get_state() if healthy and degraded else None
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
            nxt, ok, new_cache = self._launch(self._decode, self.params,
                                              view, batch, "decode.launch")
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
                    # no emit, no advance: next tick this slot decodes the
                    # same position densely
                    self.slots[i].degraded = True

        if degraded:
            if rng_state is not None:
                self._gen.set_state(rng_state)
            fn, dparams = self._dense_fallback()
            nxt, ok, new_cache = self._launch(fn, dparams, view, batch,
                                              "decode.launch_degraded")
            _commit(ok, new_cache, degraded)
            for i in degraded:
                if ok[i]:
                    results[i] = int(nxt[i])
                else:
                    # dense gave no finite logits either: the poison is in
                    # this slot's history, not the sparse weights
                    any_drop = True
                    self._teardown(i, "failed")

        if n_applies != 1 or any_drop:
            # two closures (or a dropped write) each left a partial cached
            # view behind: the next gather rebuilds from the pages
            self.cache.invalidate_view()
        self.stats.steps += 1
        self.stats.decode_steps += 1
        self._occ_accum += len(decoding) / self.b
        self.stats.slot_occupancy = self._occ_accum / self.stats.decode_steps
        with self.tracer.span("decode.emit", cat="decode"):
            for i in decoding:
                st = self.slots[i]
                if st is None or i not in results:
                    continue  # torn down or quarantined: no emit/advance
                self.seq_len[i] += 1
                if st.degraded:
                    st.emitted_degraded = True
                    self.stats.degraded_tokens += 1
                    self._c_degraded_tokens.inc()
                self._emit_token(i, results[i])

    # ------------------------------------------------------------- stepping
    def step(self) -> None:
        """One engine tick: a prefill chunk for one slot, or one decode
        step across all decode-ready slots."""
        with self.tracer.span("engine.step", cat="engine"):
            with self.tracer.span("scheduler.admit", cat="scheduler"):
                self._admit()
            with self.tracer.span("scheduler.plan", cat="scheduler"):
                prefilling = [i for i, s in enumerate(self.slots)
                              if s is not None and s.phase == "prefill"]
                decoding = [i for i, s in enumerate(self.slots)
                            if s is not None and s.phase == "decode"]
                action, target = self.scheduler.next_action(prefilling,
                                                            decoding)
            if action == "prefill":
                t0 = time.monotonic()
                pf_args = {"rid": self.slots[target].req.rid,
                           "slot": target}
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

    def run(self, max_steps: int = 10_000) -> EngineStats:
        with self.tracer.span("engine.run", cat="engine"):
            for _ in range(max_steps):
                if (not self.scheduler.has_pending
                        and all(s is None for s in self.slots)):
                    break
                self.step()
        return self.stats
