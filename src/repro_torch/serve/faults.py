"""Deterministic fault injection for the serving engine (mirrors
``src/repro/serve/faults.py``).

Every injector is seeded and pure-functional over the sparse serving
dict: the original is never mutated.  Torch tensors are mutable and a
structural copy shares them, so an injector writes the plane it corrupts
into a new tensor (same device and dtype) and shares only the planes it
leaves alone — the engine's own packs keep their fingerprints.  Two
fault families:

* **load faults** — corruption that must be *rejected at engine
  construction* by the pack-integrity layer: a single bit flip anywhere
  in an index or value plane (fp, int8 or nibble-packed int4), or a
  schedule/pack mismatch (the perm planes rolled one layer — internally
  consistent, so only the bound fingerprint can catch it).
* **runtime faults** — degradation the engine must survive *without ever
  emitting a silent wrong token*: a NaN-poisoned decode closure
  (quarantine -> dense fallback), a mid-decode abort (``cancel``), arena
  OOM pressure (admission pushback via quarantined blocks), latency
  spikes (watchdog flags) and transient step errors (capped-backoff
  retry).

``run_fault_drill`` runs one engine per fault class against a no-fault
baseline and reports goodput, recovery time, degraded-token fraction and
leak counts per class; ``check_drill`` asserts the contract (reject at
load, or complete with unaffected slots bit-identical to the baseline
and zero leaked blocks).

The drills and their ``check_*`` contracts are the reference's.  Each
runtime kind's result also counts the unaffected requests' tokens equal
to the baseline's (``tokens_equal_baseline`` of ``tokens_compared``), and
the crash drill's the tokens emitted after the kill that equal the
uninterrupted run's (``tokens_after_kill_equal`` of
``tokens_after_kill``).  On the CPU the plain versions hold the contracts
bit for bit; on a GPU a resumed or degraded request recomputes its KV
through GEMMs where the baseline wrote it through the SpMV kernels, so a
card run reports these shares beside the structural contract.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.integrity import PackIntegrityError
from repro_torch.runtime.fault_tolerance import LatencyWatchdog
from repro_torch.serve.engine import (Request, ServeEngine,
                                      TransientStepError, _finite_step)
from repro_torch.serve.serve_step import serve_step_sparse_fn

__all__ = ["FAULT_KINDS", "LOAD_FAULTS", "flip_bit", "corrupt_group_plane",
           "mismatch_schedule", "poison_values", "inject_poisoned_decode",
           "force_nonfinite_flag", "arm_latency_spike",
           "arm_transient_errors", "run_fault_drill", "check_drill",
           "run_crash_drill", "check_crash_drill",
           "run_overload_drill", "check_overload_drill"]

FAULT_KINDS = ("index_bitflip", "value_bitflip", "schedule_mismatch",
               "nonfinite_logits", "abort_mid_decode", "arena_oom",
               "latency_spike", "transient_step_error")
# corruption the integrity layer must reject at engine construction
LOAD_FAULTS = ("index_bitflip", "value_bitflip", "schedule_mismatch")


# --------------------------------------------------------------- injectors
def flip_bit(arr: torch.Tensor, rng) -> torch.Tensor:
    """A copy of a tensor (same device and dtype) with one uniformly-random
    bit of its byte buffer flipped; ``arr`` itself is left as it was."""
    a = arr.detach().to("cpu", copy=True).contiguous()
    flat = a.view(-1).view(torch.uint8)
    bit = int(rng.integers(flat.numel() * 8))
    flat[bit // 8] ^= 1 << (bit % 8)
    return a.to(arr.device)


def _clone_sparse(sparse: dict) -> dict:
    """Shallow structural copy (dicts/lists new, tensors shared) so an
    injector can swap one plane without touching the caller's dict; the
    legacy top-level group aliases are re-pointed at the clones."""
    out = dict(sparse)
    out["groups"] = {}
    for name, g in sparse["groups"].items():
        g2 = dict(g)
        g2["buckets"] = [dict(b) for b in g["buckets"]]
        out["groups"][name] = g2
        out[name] = g2
    return out


def corrupt_group_plane(sparse: dict, plane: str, rng,
                        group: str | None = None) -> dict:
    """One bit flip in a group's index plane (``plane="index"``) or value
    plane (``plane="value"`` — the fp values, or the quantized codes when
    the pack is int8/int4)."""
    out = _clone_sparse(sparse)
    name = group or next(iter(out["groups"]))
    b = out["groups"][name]["buckets"][0]
    if plane == "index":
        key = "cols"
    elif plane == "value":
        key = "values" if "values" in b else "q"
    else:
        raise ValueError(f"unknown plane {plane!r}; use 'index' or 'value'")
    b[key] = flip_bit(b[key], rng)
    return out


def mismatch_schedule(sparse: dict, group: str | None = None) -> dict:
    """Pair a group's packs with the *wrong layer's* balance permutation:
    perm and inv_perm are rolled one layer together, so each layer's pair
    stays internally consistent (bounds/involution validation passes) —
    only the bound fingerprint, which ties the planes to the SDDS
    schedule they were built under, can catch it."""
    out = _clone_sparse(sparse)
    name = group or next(iter(out["groups"]))
    g = out["groups"][name]
    if g["perm"].shape[0] < 2:
        raise ValueError("schedule mismatch needs >= 2 layers to roll")
    g["perm"] = torch.roll(g["perm"], 1, dims=0)         # new tensors
    g["inv_perm"] = torch.roll(g["inv_perm"], 1, dims=0)
    return out


def poison_values(sparse: dict, rng, group: str | None = None) -> dict:
    """NaN one *retained* cell of a group's value plane (or one quant
    scale) — the runtime poison that must trip the per-slot finite guard,
    never reach an emitted token."""
    out = _clone_sparse(sparse)
    name = group or next(iter(out["groups"]))
    b = out["groups"][name]["buckets"][0]
    key = "values" if "values" in b else "srow"
    arr = b[key].detach().clone()
    if key == "values":
        idxs = np.argwhere(np.asarray(b["valid"], bool))
        pick = idxs[int(rng.integers(len(idxs)))]
        arr[tuple(int(i) for i in pick)] = float("nan")
    else:
        arr.view(-1)[int(rng.integers(arr.numel()))] = float("nan")
    b[key] = arr
    return out


def inject_poisoned_decode(eng: ServeEngine, sparse_bad: dict) -> None:
    """Swap the engine's decode closure for one built over a corrupted
    sparse dict — runtime corruption *after* the load-time verification
    passed (the engine's own ``sparse`` stays clean, so its dense
    fallback reconstructs uncontaminated weights).  The new closure
    samples from the engine's generator on the engine's device and
    donates the view where the engine's own closure does."""
    cfg, temperature, impl = eng.cfg, eng.temperature, eng.impl
    eng._decode = _finite_step(
        lambda p, c, b: serve_step_sparse_fn(cfg, p, sparse_bad, c, b,
                                             temperature=temperature,
                                             impl=impl, generator=eng._gen,
                                             device=eng.device,
                                             donate=eng._donate))


def force_nonfinite_flag(eng: ServeEngine, slots, n_calls: int = 1):
    """Mark the given slots non-finite for the next ``n_calls`` decode
    calls (the guard-path injector for dense engines, where there is no
    sparse plane to poison)."""
    inner = eng._decode
    state = {"left": n_calls}

    def wrapped(p, c, b):
        nxt, ok, cache = inner(p, c, b)
        if state["left"] > 0:
            state["left"] -= 1
            ok = ok.clone()
            for s in slots:
                ok[s] = False
        return nxt, ok, cache

    eng._decode = wrapped
    return state


def arm_latency_spike(eng: ServeEngine, at_call: int, n_calls: int,
                      sleep_s: float):
    """Stall decode calls ``at_call .. at_call+n_calls-1`` by ``sleep_s``
    — the watchdog-visible stuck-decode simulation."""
    inner = eng._decode
    state = {"calls": 0}

    def wrapped(p, c, b):
        state["calls"] += 1
        if at_call <= state["calls"] < at_call + n_calls:
            time.sleep(sleep_s)
        return inner(p, c, b)

    eng._decode = wrapped
    return state


def arm_transient_errors(eng: ServeEngine, at_call: int, n_failures: int):
    """From decode call ``at_call`` on, raise ``TransientStepError`` for
    the next ``n_failures`` calls, then heal — exercises the engine's
    capped-backoff retry (each retry re-enters the wrapper and counts)."""
    inner = eng._decode
    state = {"calls": 0, "fails": 0}

    def wrapped(p, c, b):
        state["calls"] += 1
        if state["calls"] >= at_call and state["fails"] < n_failures:
            state["fails"] += 1
            raise TransientStepError(
                f"injected transient failure #{state['fails']}")
        return inner(p, c, b)

    eng._decode = wrapped
    return state


# ------------------------------------------------------------------- drill
def _drill_requests(cfg, rng, n_requests: int, max_new_tokens: int):
    return [Request(rid=r,
                    prompt=[int(t) for t in rng.integers(
                        1, cfg.vocab_size, 5 + int(rng.integers(4)))],
                    max_new_tokens=max_new_tokens)
            for r in range(n_requests)]


def _drain(eng: ServeEngine, reqs, on_step=None, max_steps: int = 4000):
    for r in reqs:
        eng.submit(r)
    steps = 0
    while steps < max_steps and (eng.scheduler.has_pending
                                 or any(s is not None for s in eng.slots)):
        eng.step()
        steps += 1
        if on_step is not None:
            on_step(eng, steps)
    return steps


def run_fault_drill(cfg, params, sparse: dict, sparse_alt: dict | None = None,
                    seed: int = 0, kinds=None, *, impl: str | None = None,
                    device=None,
                    batch_slots: int = 2, max_len: int = 64,
                    block_size: int = 8, prefill_chunk: int = 8,
                    n_requests: int = 4, max_new_tokens: int = 8,
                    tracer=None) -> dict:
    """One engine per fault class against a shared no-fault baseline.

    ``sparse`` is a pack dict (``sparsify_model``), fp or quantized; with
    an fp ``sparse``, pass a quantized dict as ``sparse_alt`` to aim the
    value-plane bit flip at the narrow codes instead of fp values.  Greedy decode is
    batching-independent, so per-request outputs are comparable
    bit-for-bit across engines — "unaffected slots identical to the
    no-fault run" is an exact assertion, not a tolerance.

    ``tracer`` (a telemetry ``Tracer``) is threaded into every drill
    engine, so a traced drill's export carries the quarantine / retry /
    watchdog instants next to the step spans that absorbed them.
    """
    kinds = tuple(kinds) if kinds is not None else FAULT_KINDS
    rng = np.random.default_rng(seed)
    reqs = _drill_requests(cfg, rng, n_requests, max_new_tokens)
    prompts = {r.rid: list(r.prompt) for r in reqs}

    def _fresh_reqs():
        return [Request(rid=rid, prompt=list(p),
                        max_new_tokens=max_new_tokens)
                for rid, p in prompts.items()]

    def _mk_engine(sparse_arg, **kw):
        return ServeEngine(
            cfg, params, batch_slots, max_len, sparse=sparse_arg, impl=impl,
            device=device, block_size=block_size,
            prefill_chunk=prefill_chunk, validate_arena=True, tracer=tracer,
            watchdog=LatencyWatchdog(threshold=3.0, patience=2,
                                     min_samples=4), **kw)

    # ---- no-fault baseline ---------------------------------------------
    base_reqs = _fresh_reqs()
    eng = _mk_engine(sparse)
    t0 = time.monotonic()
    _drain(eng, base_reqs)
    base_wall = time.monotonic() - t0
    baseline = {r.rid: list(r.output) for r in base_reqs}
    out = {"seed": seed,
           "scale": {"batch_slots": batch_slots, "max_len": max_len,
                     "block_size": block_size, "n_requests": n_requests,
                     "max_new_tokens": max_new_tokens},
           "baseline": {
               "goodput_tok_s": eng.stats.tokens_generated / max(base_wall,
                                                                 1e-9),
               "tokens": eng.stats.tokens_generated,
               "wall_s": base_wall},
           "faults": {}}

    for kind in kinds:
        out["faults"][kind] = _drill_one(
            kind, _mk_engine, _fresh_reqs, baseline, sparse, sparse_alt,
            np.random.default_rng(seed + 1))
    return out


def _drill_one(kind, _mk_engine, _fresh_reqs, baseline, sparse, sparse_alt,
               rng) -> dict:
    res = {"rejected_at_load": False}

    if kind in LOAD_FAULTS:
        if kind == "index_bitflip":
            bad = corrupt_group_plane(sparse, "index", rng)
        elif kind == "value_bitflip":
            bad = corrupt_group_plane(sparse_alt or sparse, "value", rng)
        else:
            bad = mismatch_schedule(sparse)
        try:
            _mk_engine(bad)
        except PackIntegrityError as e:
            res["rejected_at_load"] = True
            res["error"] = str(e)[:200]
        return res

    reqs = _fresh_reqs()
    kw = {"max_retries": 3} if kind == "transient_step_error" else {}
    eng = _mk_engine(sparse, **kw)
    affected: set = set()
    t_fault = [None]

    def _mark(now=None):
        if t_fault[0] is None:
            t_fault[0] = time.monotonic()

    if kind == "latency_spike":
        arm_latency_spike(eng, at_call=10, n_calls=4, sleep_s=0.25)
    elif kind == "transient_step_error":
        arm_transient_errors(eng, at_call=6, n_failures=2)

    def on_step(e, step):
        if kind == "nonfinite_logits" and step == 6 and t_fault[0] is None:
            _mark()
            inject_poisoned_decode(e, poison_values(sparse, rng))
        elif kind == "abort_mid_decode" and step == 4 and t_fault[0] is None:
            occupied = [s for s in e.slots if s is not None]
            if occupied:
                _mark()
                affected.add(occupied[0].req.rid)
                e.cancel(occupied[0].req.rid)
        elif kind == "arena_oom":
            if step == 2 and t_fault[0] is None:
                _mark()
                e.cache.quarantine_blocks(e.cache.free_blocks // 2)
            elif step == 12:
                e.cache.release_quarantined()

    t0 = time.monotonic()
    _drain(eng, reqs, on_step=on_step)
    wall = time.monotonic() - t0
    eng.cache.release_quarantined()   # idempotent; guards early drains
    eng.check_arena()

    st = eng.stats
    parity = all(
        (r.output == baseline[r.rid])
        for r in reqs if r.rid not in affected)
    compared = [(a, b) for r in reqs if r.rid not in affected
                for a, b in zip(r.output, baseline[r.rid])]
    states = st.latency_summary()["states"]
    res.update({
        "affected_rids": sorted(affected),
        "states": states,
        "tokens": st.tokens_generated,
        "degraded_tokens": st.degraded_tokens,
        "degraded_token_fraction":
            st.degraded_tokens / max(1, st.tokens_generated),
        "quarantines": st.quarantines,
        "retries": st.retries,
        "watchdog_flags": st.watchdog_flags,
        "leaked_blocks": eng.cache.num_blocks - eng.cache.free_blocks,
        "unaffected_parity": bool(parity),
        "tokens_compared": len(compared),
        "tokens_equal_baseline": sum(a == b for a, b in compared),
        "goodput_tok_s": st.tokens_generated / max(wall, 1e-9),
        "recovery_s": (None if t_fault[0] is None
                       else time.monotonic() - t_fault[0]),
        "wall_s": wall,
    })
    return res


def run_crash_drill(cfg, params, sparse: dict | None = None, seed: int = 0,
                    *, impl: str | None = None, device=None,
                    batch_slots: int = 2,
                    max_len: int = 64, block_size: int = 8,
                    prefill_chunk: int = 8, n_requests: int = 4,
                    max_new_tokens: int = 8, kill_step: int | None = None,
                    tracer=None) -> dict:
    """Crash-consistency drill (DESIGN.md §13): run a trace to completion
    for a baseline, then run a second engine and *kill it* at an
    arbitrary step boundary — snapshot, discard the engine, restore the
    snapshot into a fresh engine and drain.  The contract: every request
    finishes with greedy output bit-identical to the uninterrupted run,
    and the restored engine leaks zero blocks.  The snapshot round-trips
    through its JSON text form, so what is asserted is what a crash
    handler would actually write to disk."""
    from repro_torch.serve import snapshot as snapmod

    rng = np.random.default_rng(seed)
    reqs = _drill_requests(cfg, rng, n_requests, max_new_tokens)
    prompts = {r.rid: list(r.prompt) for r in reqs}

    def _fresh_reqs():
        return [Request(rid=rid, prompt=list(p),
                        max_new_tokens=max_new_tokens)
                for rid, p in prompts.items()]

    def _mk_engine():
        return ServeEngine(
            cfg, params, batch_slots, max_len, sparse=sparse, impl=impl,
            device=device, block_size=block_size,
            prefill_chunk=prefill_chunk, validate_arena=True, tracer=tracer)

    # ---- uninterrupted baseline ----------------------------------------
    base_reqs = _fresh_reqs()
    eng = _mk_engine()
    total_steps = _drain(eng, base_reqs)
    baseline = {r.rid: list(r.output) for r in base_reqs}

    # ---- the run that dies ---------------------------------------------
    if kill_step is None:
        kill_step = int(rng.integers(1, max(2, total_steps)))
    victim_reqs = _fresh_reqs()
    eng = _mk_engine()
    for r in victim_reqs:
        eng.submit(r)
    for _ in range(kill_step):
        if (not eng.scheduler.has_pending
                and all(s is None for s in eng.slots)):
            break
        eng.step()
    snap_text = snapmod.dumps(eng.snapshot())
    in_flight = sum(1 for r in victim_reqs if not r.done)
    committed = {r.rid: len(r.output) for r in victim_reqs}
    # the crash is exactly when a post-mortem needs the flight ring: dump
    # it (when the process recorder opted into autodump) before the
    # engine object disappears
    eng.flight.record("fault", "crash_drill",
                      {"kill_step": kill_step, "in_flight": in_flight})
    flight_dump = eng.flight.trip("crash_drill", registry=eng.metrics)
    del eng                                 # the "crash": engine is gone

    # ---- restore into a fresh engine and drain -------------------------
    t0 = time.monotonic()
    eng2 = _mk_engine()
    snap = snapmod.loads(snap_text)
    restored = eng2.restore(snap, {r.rid: r for r in victim_reqs})
    toks_at_restore = eng2.stats.tokens_generated
    t_first_new = [None]

    def on_step(e, step):
        if (t_first_new[0] is None
                and e.stats.tokens_generated > toks_at_restore):
            t_first_new[0] = time.monotonic() - t0

    _drain(eng2, [], on_step=on_step)
    recovery_s = time.monotonic() - t0
    eng2.check_arena()

    parity = {r.rid: r.output == baseline[r.rid] for r in victim_reqs}
    after = [(a, b) for r in victim_reqs
             for a, b in zip(r.output[committed[r.rid]:],
                             baseline[r.rid][committed[r.rid]:])]
    return {
        "seed": seed,
        "kill_step": kill_step,
        "total_steps": total_steps,
        "snapshot_bytes": len(snap_text),
        "in_flight_at_kill": in_flight,
        "restored_requests": len(restored),
        "parity": parity,
        "exact_parity": all(parity.values()),
        "tokens_after_kill": len(after),
        "tokens_after_kill_equal": sum(a == b for a, b in after),
        "leaked_blocks": eng2.cache.num_blocks - eng2.cache.free_blocks,
        "first_new_token_s": t_first_new[0],
        "recovery_s": recovery_s,
        "states": eng2.stats.latency_summary()["states"],
        "flight_dump": flight_dump,
    }


def check_crash_drill(drill: dict) -> None:
    """Assert the crash-drill contract: bit-exact parity with the
    uninterrupted run for every request, zero leaked blocks."""
    ctx = (f"crash drill (kill_step={drill['kill_step']}/"
           f"{drill['total_steps']}): {drill['parity']}")
    assert drill["exact_parity"], f"{ctx} — restored output diverged"
    assert drill["leaked_blocks"] == 0, f"{ctx} — leaked paged blocks"
    assert drill["restored_requests"] == drill["in_flight_at_kill"], \
        f"{ctx} — snapshot lost or duplicated in-flight requests"


def run_overload_drill(cfg, params, sparse: dict | None = None,
                       seed: int = 0, *, impl: str | None = None,
                       device=None, batch_slots: int = 2, max_len: int = 64,
                       block_size: int = 8, prefill_chunk: int = 8,
                       n_requests: int = 16, factor: float = 2.0,
                       max_queue_depth: int = 3,
                       shed_policy: str = "shed-largest",
                       ttft_slo_s: float = 2.0, num_blocks: int | None = None,
                       tracer=None, max_steps: int = 6000) -> dict:
    """Poisson overload burst at ``factor``x the engine's service rate.

    Arrivals are drawn per *step* from a seeded Poisson process (so the
    shed/preempt decision sequence is reproducible — only wall-clock
    latency varies run to run).  The request mix is bimodal: long
    generations that occupy the tight arena next to short ones that
    arrive blocked, which is exactly the shape where preempt-to-recompute
    pays off.  Reports goodput-under-SLO (tokens from requests whose
    TTFT met ``ttft_slo_s``, per wall second), shed/preempt counts, and
    the terminal-state census.  The contract (``check_overload_drill``):
    overload is absorbed by *policy* — shed and/or preempt — with zero
    failed requests, zero leaked blocks and no OOM."""
    rng = np.random.default_rng(seed)
    # bimodal mix: heavy generations + short ones (rids interleaved)
    reqs = []
    for r in range(n_requests):
        if r % 2 == 0:
            mnew = 12 + int(rng.integers(5))        # long: 12-16 new
            plen = 6 + int(rng.integers(4))
        else:
            mnew = 3 + int(rng.integers(3))         # short: 3-5 new
            plen = 4 + int(rng.integers(3))
        reqs.append(Request(
            rid=r, max_new_tokens=mnew,
            prompt=[int(t) for t in rng.integers(1, cfg.vocab_size, plen)]))
    mean_steps = float(np.mean(
        [len(r.prompt) / prefill_chunk + r.max_new_tokens for r in reqs]))
    lam = factor * batch_slots / mean_steps     # requests per engine step
    if num_blocks is None:
        # arena sized so one long resident starves a short arrival (a
        # blocked short next to a long-remaining resident is the shape
        # preempt-to-recompute exists for), while still admitting every
        # request on its own
        worst = max(r.worst_case_tokens(max_len) for r in reqs)
        num_blocks = (worst + block_size - 1) // block_size + 1
    eng = ServeEngine(
        cfg, params, batch_slots, max_len, sparse=sparse, impl=impl,
        device=device, block_size=block_size, num_blocks=num_blocks,
        prefill_chunk=prefill_chunk, validate_arena=True, tracer=tracer,
        max_queue_depth=max_queue_depth, shed_policy=shed_policy,
        preempt=True, watermark_high=0.97)

    submitted = 0
    max_queue = 0
    t0 = time.monotonic()
    steps = 0
    while steps < max_steps:
        if submitted < n_requests:
            for _ in range(int(rng.poisson(lam))):
                if submitted >= n_requests:
                    break
                eng.submit(reqs[submitted])
                submitted += 1
        elif (not eng.scheduler.has_pending
                and all(s is None for s in eng.slots)):
            break
        eng.step()
        steps += 1
        max_queue = max(max_queue, eng.scheduler.queue_depth)
    wall = time.monotonic() - t0
    eng.check_arena()

    st = eng.stats
    states = st.latency_summary()["states"]
    good_tokens = sum(
        m.n_out for m in eng.scheduler.completed
        if m.state in ("completed", "degraded")
        and m.ttft is not None and m.ttft <= ttft_slo_s)
    return {
        "seed": seed,
        "factor": factor,
        "shed_policy": shed_policy,
        "scale": {"batch_slots": batch_slots, "num_blocks": num_blocks,
                  "max_queue_depth": max_queue_depth,
                  "n_requests": n_requests, "lambda_per_step": lam},
        "steps": steps,
        "wall_s": wall,
        "states": states,
        "tokens": st.tokens_generated,
        "sheds": st.requests_shed,
        "preempts": st.preempts,
        "max_queue_depth_seen": max_queue,
        "goodput_tokens_under_slo": good_tokens,
        "goodput_tok_s_under_slo": good_tokens / max(wall, 1e-9),
        "leaked_blocks": eng.cache.num_blocks - eng.cache.free_blocks,
        "drained": steps < max_steps,
    }


def check_overload_drill(drill: dict) -> None:
    """Assert the overload contract: the burst is absorbed by policy
    (shedding and/or preemption engaged), nothing fails or leaks, and
    the engine drains — overload degrades goodput, never correctness."""
    ctx = f"overload drill: {drill}"
    assert drill["drained"], f"{ctx} — engine never drained (livelock?)"
    assert drill["leaked_blocks"] == 0, f"{ctx} — leaked paged blocks"
    assert drill["states"].get("failed", 0) == 0, f"{ctx} — requests failed"
    assert drill["sheds"] + drill["preempts"] >= 1, \
        f"{ctx} — 2x overload absorbed without any policy action"
    served = (drill["states"].get("completed", 0)
              + drill["states"].get("degraded", 0))
    assert served >= 1, f"{ctx} — nothing completed under overload"


def check_drill(drill: dict) -> None:
    """Assert the fault-drill contract: every load fault rejected at
    construction; every runtime fault drains with zero leaked blocks,
    bit-identical unaffected slots and the expected counters — a failed
    assertion here means a fault class could have produced a silent
    wrong token or a resource leak."""
    for kind, r in drill["faults"].items():
        ctx = f"fault drill {kind!r}: {r}"
        if kind in LOAD_FAULTS:
            assert r["rejected_at_load"], f"{ctx} — corruption not rejected"
            continue
        assert r["leaked_blocks"] == 0, f"{ctx} — leaked paged blocks"
        assert r["unaffected_parity"], \
            f"{ctx} — unaffected slot diverged from the no-fault run"
        states = r["states"]
        if kind == "nonfinite_logits":
            assert r["quarantines"] >= 1, f"{ctx} — guard never tripped"
            assert r["degraded_tokens"] >= 1, \
                f"{ctx} — no dense-fallback tokens"
            assert states.get("failed", 0) == 0, f"{ctx} — slots failed"
        elif kind == "abort_mid_decode":
            assert states.get("cancelled", 0) >= 1, f"{ctx} — no cancel"
        elif kind == "arena_oom":
            assert states.get("failed", 0) == 0, f"{ctx} — slots failed"
        elif kind == "latency_spike":
            assert r["watchdog_flags"] >= 1, f"{ctx} — watchdog silent"
        elif kind == "transient_step_error":
            assert r["retries"] >= 1, f"{ctx} — retry path never ran"
            assert states.get("failed", 0) == 0, f"{ctx} — retry exhausted"
