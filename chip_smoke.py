#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out DIR]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
library per source, one nvcc each, all started together) and drives the
port's paths at the full width of ``llama7b-espim`` (random weights from
``--seed``): int8 ESPIM decode through ``ServeEngine`` (depth cut to 2
layers), the standalone projection layers, the dense serving mode and the
fault ladder's dense rungs, and the ops of the other kernels — then
checks them:

1. build: nvcc the kernels, print the build time and ptxas' report, and
   the tensor-core instructions in the flash library's SASS (HGMMA for
   wgmma, HMMA for mma.sync); fails if its bf16 (wgmma) body holds no
   HGMMA or its fp32 (3xTF32) body no HMMA;
2. engine: 8 requests through the int8 engine (kernels 2 and 4), then 4
   through a 1-layer fp engine (kernels 1 and 3), each trace served 3
   times; every launch counter is zeroed just before each serve and read
   just after, and each kernel of the path must have launched;
3. decode parity: 4 teacher-forced decode steps at B=4 through the kernels
   and through their plain versions, from the same packs and cache; then
   one decode step's host time, and from ``torch.profiler``'s device
   kernel spans the device-busy share and the SpMV share of device time;
4. SpMV kernels: the five kernels on the streaming body (1-4 and the
   residual kernel 6) against their plain versions at the engine packs'
   full-width bucket shapes (plus int4 planes, one QKV and one gate+up
   bucket with an odd Lc, and kernels 1, 3 and 6 on the fp32 packs'
   planes cast to bf16), B in {1, 2, 3, 4, 8, 13}, each launched twice
   for identical bits; then kernels 1-4 timed per layer at B in {1, 4},
   and each bucket launch of kernels 1-4 and 6 at B = 4 on its own (a
   graph of an L2-evicting read and the launch, less the read): rows, K,
   Lc, µs and GB/s.  This runs before any flash attention launch, so the
   timings do not depend on what the attention kernels leave behind;
5. projection: ``ESPIMGroupLinear`` over layer 0's wq/wk/wv and
   ``ESPIMLinear`` over its w_down at 90% sparsity, fp32 and int8, each
   called with a 1-D x (kernel 5 / kernel 2) and with (4, n_in)
   (kernels 1 / 2), against ``impl="ref"`` and the dense pruned
   (dequantized) fp32 product; then the dense datapath once; counters
   zeroed before the phase and read after, and kernel 5 must launch;
6. dense: ``ServeEngine(sparse=None)`` over the unpruned bf16 params of
   the 2-layer model, bf16 and int8 KV cache, the same trace 3 times
   after a warm-up, every launch counter zero after each serve; 4
   teacher-forced fp32 dense decode steps at B=4 (the 1-layer model) on
   the card against the CPU, and int8-KV against bf16-KV logits on the
   card; the dense step profiled as in step 3 at B in {1, 4}, the int8
   sparse step at B=1, and one line setting the two side by side; the
   quarantine drill (the int8 engine's decode swapped at tick 5 for one
   over packs with a NaN row scale: every request finishes, some on the
   dense fallback, none failed, no block leaked; how many tokens equal
   the no-fault run's is reported, not required); degrade at load (a
   flipped code bit raises by default and with
   ``on_verify_failure="degrade"`` the engine serves dense);
7. ops: the residual epilogue over the fp32 engine's attn_out and down
   buckets, ``ops.dense_mv`` and ``flash_attention`` at the shapes of
   step 8, counters zeroed before and read after;
8. kernels 5-8 against their plain versions, each launched twice for
   identical bits: the unbatched kernel on the projection packs in fp32
   and bf16; the residual kernel per call at B in {1, 4} (and on bf16
   planes at B = 4); dense MV at (4096, 4096), (4096, 11008) and
   (11008, 4096) in fp32 and bf16; flash attention at BH = 32, hd = 128,
   S in {77, 512, 2048}, and at hd 32, 64 and 80 (zero-padded to 128)
   with a ragged S = 200, causal or not, fp32 and bf16 (bf16 also within
   a bound on the relative L2 error of the whole output) — each with its
   time, the plain version's, a library call of the same function that
   the port never makes (each timed by CUDA events around replays of a
   captured CUDA graph), and the least time the card could take.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Exits non-zero, with no result,
when there is no CUDA device, when the port's sources are missing, or when
any check fails.  Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
ARCH = "llama7b-espim"
PROMPT_LENS = [3, 40, 2, 56, 5, 24, 4, 12]
MAX_NEW = 12
ENGINE_KW = dict(batch_slots=4, max_len=128, block_size=16, prefill_chunk=16,
                 policy="sjf")
N_LAYERS_INT8, N_LAYERS_FP = 2, 1       # depth cut of the int8 / fp32 engines
ENGINE_RUNS = 3                         # measured serves of the trace
PROJ_SPARSITY = 0.9                     # the projection phase's pruning
FLASH_BH, FLASH_HD = 32, 128            # llama7b's heads at B = 1
FLASH_SEQS = (77, 512, 2048)
# the other head widths the kernel is built for, at a ragged S: every
# instantiation, and both swizzle widths of the bf16 body, run on the card;
# hd 80 (zamba2-2.7b's) runs zero-padded to 128
FLASH_RAGGED_SEQ, FLASH_OTHER_HDS = 200, (32, 64, 80)
# llama's square projections, w_down's and the gate/up projections' shapes
DENSE_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))
# data-sheet memory bandwidth, bytes/s, by card name (NVIDIA data sheets)
_BANDWIDTH = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
              ("H100", 3.35e12))
# H100 SXM data sheet peaks: float32 outside the tensor cores, bf16 on the
# tensor cores (the bound of bf16 attention), and TF32 on the tensor cores
# over the three products of a 3xTF32 split (the bound of fp32 attention,
# whose body runs them)
PEAKS = {"fp32": 67e12, "bf16_tensor": 989e12, "tf32x3_tensor": 495e12 / 3}
KERNEL_REL_TOL, KERNEL_ABS_TOL = 1e-5, 1e-6
# kernels 1-4 and 6 (the streaming body) are checked at every batch tile
# (1, 2, 4, 8), a tile's remainder (3) and the loop over tiles of 8 (13),
# and each of their bucket launches is timed at B = 4; every SpMV kernel
# is timed per layer (kernel 6: per call) at B in {1, 4}
STREAM_KERNELS = ("espim_spmv_batched", "espim_spmv_batched_quant",
                  "espim_spmv_batched_glu", "espim_spmv_batched_quant_glu",
                  "espim_spmv_batched_res")
CHECK_BATCHES = (1, 2, 3, 4, 8, 13)
TOP_KERNELS = 8                 # a step profile lists the kernels taking most
TIME_BATCHES = (1, 4)
# the SpMV kernels' names in a profiler trace: espim_spmv.cu's
# warp-per-row body and the streaming body's two kernels
SPMV_KERNEL_NAMES = ("espim_spmv_kernel", "espim_spmv_stream_kernel",
                     "espim_spmv_stream_glu_kernel")
# bf16 inputs and attention: the JAX package's own test tolerances, as
# |kernel - plain| <= atol + rtol * |plain| elementwise
# (tests/test_kernels.py:36,84, tests/test_flash_kernel.py:32,43)
ALLCLOSE_TOL = {"espim_spmv/bf16": 3e-2, "dense_mv/bf16": 5e-2,
                "flash_attention/fp32": 2e-5, "flash_attention/bf16": 5e-2}
# bf16 attention is also held as a whole, ||kernel - plain||_2 /
# ||plain||_2: at S = 2048 softmax averages hundreds of keys, the outputs
# spread only ~0.04 and the elementwise limit above can pass a body that
# dropped a key tile.  The bound sits between sound runs' readings and a
# planted dropped key tile's (PERF.md)
REL_L2_TOL = {"flash_attention/bf16": 1e-2}
LOGIT_COS_MIN = 0.999
# the dense step in fp32 on the card against the CPU: cuBLAS and the CPU
# sum each product in another order, |diff| ~1e-6 of |logits| a layer
DENSE_LOGIT_REL_TOL = 1e-4
# int8 against bf16 KV cache logits, max|diff| / max|bf16|: the JAX
# package's own bound (tests/test_kv_quant.py:33)
KV_QUANT_REL_TOL = 5e-2
# bf16 activations between layers: an fp32 sum-order difference flips a
# q/k/v element by one bf16 ulp (2^-8 of it) now and then, and the flips
# propagate through the later layers and steps
KV_REL_TOL = 2e-2

# kernel -> (pallas_call it replaces, Pallas function, port source)
_SPMV_CU = "src/repro_torch/kernels/csrc/espim_spmv.cu"
_KERNELS = {
    "espim_spmv_batched": ("src/repro/kernels/espim_spmv.py:649",
                           "espim_spmv_batched_pallas", _SPMV_CU),
    "espim_spmv_batched_quant": ("src/repro/kernels/espim_spmv.py:321",
                                 "espim_spmv_batched_quant_pallas", _SPMV_CU),
    "espim_spmv_batched_glu": ("src/repro/kernels/espim_spmv.py:489",
                               "espim_spmv_batched_glu_pallas", _SPMV_CU),
    "espim_spmv_batched_quant_glu": ("src/repro/kernels/espim_spmv.py:565",
                                     "espim_spmv_batched_quant_glu_pallas",
                                     _SPMV_CU),
    "espim_spmv": ("src/repro/kernels/espim_spmv.py:130",
                   "espim_spmv_pallas", _SPMV_CU),
    "espim_spmv_batched_res": ("src/repro/kernels/espim_spmv.py:605",
                               "espim_spmv_batched_res_pallas", _SPMV_CU),
    "dense_mv": ("src/repro/kernels/dense_mv.py:53", "dense_mv_pallas",
                 "src/repro_torch/kernels/csrc/dense_mv.cu"),
    "flash_attention": ("src/repro/kernels/flash_attention.py:99",
                        "flash_attention_pallas",
                        "src/repro_torch/kernels/csrc/flash_attention.cu"),
}


class SmokeFailure(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_bandwidth(name: str) -> float:
    for key, bw in _BANDWIDTH:
        if key in name:
            return bw
    raise SmokeFailure(f"no data-sheet bandwidth for card {name!r}")


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    need(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def sass_tensor_ops(path) -> dict:
    """{kernel function: {"HGMMA": n, "HMMA": n}}: the tensor-core
    instructions in ``cuobjdump --dump-sass`` of a built library (HGMMA
    is wgmma, HMMA mma.sync)."""
    from repro_torch.kernels.build import find_nvcc
    tool = Path(find_nvcc()).parent / "cuobjdump"
    proc = subprocess.run([str(tool), "--dump-sass", str(path)],
                          capture_output=True, text=True, timeout=300)
    need(proc.returncode == 0,
         f"cuobjdump failed on {path}: {proc.stderr.strip()[:500]}")
    out, fn = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn:
            for op in out[fn]:
                out[fn][op] += len(re.findall(rf"\b{op}\.", line))
    return out


class Timer:
    """Median milliseconds of device time per call of ``fn``.

    ``fn``'s launches are captured once into a CUDA graph and the graph is
    replayed ``reps`` times between two CUDA events, in ``trials`` rounds:
    replay issues the whole launch sequence at once, so the time is the
    kernels' own and not the Python launch path's (which, for ~50 us
    kernels, is as slow as the kernels)."""

    def __init__(self, torch):
        self.torch = torch

    def __call__(self, fn, reps: int = 10, trials: int = 5) -> float:
        torch = self.torch
        out = []
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):          # warm-up before capture
            fn()
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        graph.replay()
        for _ in range(trials):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                graph.replay()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b) / reps)
        del graph
        return statistics.median(out)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------
def phase_build(report: dict) -> None:
    """nvcc every source at once, then load each library; then the
    tensor-core instructions of the flash library's kernels."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.load_library(name)
    dt = time.perf_counter() - t0
    report["build"] = {"seconds": dt, "libraries": {}}
    log(f"[build] {len(build.SOURCES)} libraries in {dt:.1f} s")
    for name, rec in build.BUILD_LOG.items():
        report["build"]["libraries"][name] = {
            "nvcc_seconds": rec["seconds"], "cached": rec["cached"],
            "ptxas": rec["log"]}
        log(f"[build] {build.SOURCES[name].relative_to(ROOT)} -> "
            f"{Path(rec['path']).name}: nvcc {rec['seconds']:.1f} s "
            f"(cached={rec['cached']})")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    sass = sass_tensor_ops(build.library_path("flash_attention"))
    report["build"]["flash_attention_sass"] = sass
    for fn, n in sass.items():
        log(f"[build] flash_attention SASS {fn}: HGMMA {n['HGMMA']}, "
            f"HMMA {n['HMMA']}")
    # the bf16 body runs wgmma (HGMMA), the fp32 body mma.sync (HMMA)
    for body, op in (("flash_attention_wgmma_kernel", "HGMMA"),
                     ("flash_attention_tf32_kernel", "HMMA")):
        found = [n[op] for fn, n in sass.items() if body in fn]
        need(bool(found) and all(found),
             f"[build] a {body} instance holds no {op} instruction")


def _counter_modules():
    from repro_torch.kernels import dense_mv, espim_spmv, flash_attention
    return espim_spmv, dense_mv, flash_attention


def reset_launches() -> None:
    for mod in _counter_modules():
        mod.reset_launches()


def read_launches() -> dict:
    return {k: v for mod in _counter_modules()
            for k, v in mod.LAUNCHES.items()}


def layer_slice(params: dict, n: int) -> dict:
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = {m: {k: w[:n] for k, w in sub.items()}
                     for m, sub in params["layers"].items()}
    return out


def serve(engine_mod, eng, prompts, max_new: int, inject=None):
    """Submit ``prompts`` and run the engine until all have finished ->
    (requests, stats, wall seconds).  ``inject=(n, fn)`` calls
    ``fn(eng)`` after the n-th tick."""
    reqs = [engine_mod.Request(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    if inject is not None:
        eng.run(max_steps=inject[0])
        inject[1](eng)
    stats = eng.run()
    return reqs, stats, time.perf_counter() - t0


def drive_engine(ctx, label, cfg, params, sparse, prompts, kernels) -> dict:
    """Warm up, then ``ENGINE_RUNS`` times: zero the launch counters, serve
    ``prompts``, read the counters; every kernel in ``kernels`` must have
    launched in every run, and a dense engine (``sparse=None``) must have
    launched none.  Reports each run's tok/s, TTFT and TPOT p50, their
    medians, and the last run's launch counts and outputs."""
    from repro_torch.serve import engine as E
    from repro_torch.serve.scheduler import latency_summary
    torch = ctx["torch"]
    eng = E.ServeEngine(cfg, params, sparse=sparse, device=ctx["device"],
                        **ENGINE_KW)
    serve(E, eng, [prompts[0][:3]], 2)                 # warm-up request
    runs = []
    for _ in range(ENGINE_RUNS):
        eng.reset_stats()
        reset_launches()
        reqs, stats, wall = serve(E, eng, prompts, MAX_NEW)
        launches = read_launches()
        for r in reqs:
            need(len(r.output) == MAX_NEW,
                 f"[{label}] request {r.rid} produced {len(r.output)} tokens")
            need(all(0 <= t < cfg.vocab_size for t in r.output),
                 f"[{label}] request {r.rid} sampled an id outside the vocab")
        need(stats.requests_completed == len(prompts),
             f"[{label}] {stats.requests_completed}/{len(prompts)} completed")
        # a measured serve runs its own datapath only: no slot went to
        # the dense fallback (the quarantine drill has its own engine)
        need(stats.quarantines == stats.requests_degraded
             == stats.degraded_tokens == 0,
             f"[{label}] {stats.quarantines} quarantines, "
             f"{stats.requests_degraded} degraded requests, "
             f"{stats.degraded_tokens} degraded tokens")
        for k in kernels:
            need(launches[k] > 0, f"[{label}] kernel {k} never launched")
        if sparse is None:
            need(not any(launches.values()),
                 f"[{label}] the dense engine launched kernels {launches}")
        eng.check_arena()
        lat = latency_summary(stats.requests)      # exact percentiles
        runs.append({"tokens": stats.tokens_generated, "wall_s": wall,
                     "tok_per_s": stats.tokens_generated / wall,
                     "ttft_p50_s": lat["ttft_s"]["p50"],
                     "tpot_p50_s": lat["tpot_s"]["p50"]})
    rec = {"requests": len(prompts), "tokens": stats.tokens_generated,
           "runs": runs, "outputs": [r.output for r in reqs],
           **{k: statistics.median(r[k] for r in runs)
              for k in ("tok_per_s", "ttft_p50_s", "tpot_p50_s")},
           "decode_steps": stats.decode_steps,
           "prefill_chunks": stats.prefill_chunks,
           "launches": launches,
           "launches_per_decode_step": {
               k: v / max(1, stats.decode_steps) for k, v in launches.items()},
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}

    def spread(key, scale, fmt):
        return "/".join(format(r[key] * scale, fmt) for r in runs)

    log(f"[engine:{label}] {len(prompts)} requests, "
        f"{stats.tokens_generated} tokens per run, {ENGINE_RUNS} runs: "
        f"{spread('tok_per_s', 1, '.1f')} tok/s; TTFT p50 "
        f"{spread('ttft_p50_s', 1e3, '.1f')} ms; TPOT p50 "
        f"{spread('tpot_p50_s', 1e3, '.2f')} ms; {stats.decode_steps} decode "
        f"steps, {stats.prefill_chunks} prefill chunks")
    log(f"[engine:{label}] launches {launches}; per decode step "
        + ", ".join(f"{k} {v:g}" for k, v in
                    rec["launches_per_decode_step"].items() if v))
    return rec


def decode_parity(ctx, label, cfg, params, sparse, steps=4, b=4) -> dict:
    """Teacher-forced decode through the kernels and the plain versions."""
    from repro_torch.core.sparse_model import decode_step_sparse
    from repro_torch.models.transformer import init_cache
    torch, dev = ctx["torch"], ctx["device"]
    gen = torch.Generator().manual_seed(ctx["seed"] + 1)
    toks = torch.randint(0, cfg.vocab_size, (b, steps), generator=gen,
                         dtype=torch.int32).to(dev)
    c0 = init_cache(cfg, b, steps + 4, device=dev)
    caches = {"kernel": c0, "plain": c0}
    worst_cos = 1.0
    for s in range(steps):
        batch = {"tokens": toks[:, s:s + 1]}
        out = {}
        for path, impl in (("kernel", ctx["impl"]), ("plain", "ref")):
            out[path], caches[path] = decode_step_sparse(
                cfg, params, sparse, caches[path], batch, impl=impl,
                device=dev)
        lk, lp = (out[p][:, 0].float() for p in ("kernel", "plain"))
        need(bool(torch.isfinite(lk).all()), f"[{label}] non-finite logits")
        cos = torch.nn.functional.cosine_similarity(lk, lp, dim=-1)
        worst_cos = min(worst_cos, float(cos.min()))
    need(worst_cos >= LOGIT_COS_MIN,
         f"[{label}] logits cosine {worst_cos:.6f} < {LOGIT_COS_MIN}")
    kv = {}
    for name in ("k", "v"):
        a = caches["kernel"][name].float()
        r = caches["plain"][name].float()
        rel = float((a - r).abs().max() / r.abs().max().clamp_min(1e-30))
        kv[name] = rel
        need(rel <= KV_REL_TOL,
             f"[{label}] KV {name} max|diff|/max|plain| {rel:.3e} > "
             f"{KV_REL_TOL}")
    log(f"[parity:{label}] {steps} steps B={b}: min logits cosine "
        f"{worst_cos:.6f} (>= {LOGIT_COS_MIN}); KV max|diff|/max|plain| "
        f"k {kv['k']:.3e} v {kv['v']:.3e} (<= {KV_REL_TOL})")
    return {"min_logit_cosine": worst_cos, "kv_rel_err": kv}


def decode_step_profile(ctx, label, cfg, step_fn, b=4, reps=10) -> dict:
    """Where a decode step's time goes: host-clock time of one
    ``step_fn(cache, batch)`` call (synchronised), and, from
    ``torch.profiler`` over ``reps`` steps, the device-busy share, the
    device kernels per step, the SpMV kernels' share of device time and
    the device µs per step of the kernels that take the most."""
    from repro_torch.models.transformer import init_cache
    torch, dev = ctx["torch"], ctx["device"]
    cache = init_cache(cfg, b, 64, device=dev)
    cache["len"] = torch.full((b,), 32, dtype=torch.int32, device=dev)
    batch = {"tokens": torch.ones((b, 1), dtype=torch.int32, device=dev)}

    def step():
        return step_fn(cache, batch)

    step()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    rec = {"step": label, "B": b, "layers": cfg.n_layers, "cache_len": 32,
           "step_ms": statistics.median(walls), "device_busy_share": None,
           "spmv_share_of_device": None, "device_ms_per_step": None,
           "kernels_per_step": None}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: a CPU op's device time repeats its kernels'
    spans, spmv_us, by_name = [], 0.0, {}
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        us = e.time_range.elapsed_us()
        name = e.name[:60]
        cnt, tot = by_name.get(name, (0, 0.0))
        by_name[name] = (cnt + 1, tot + us)
        if any(n in e.name for n in SPMV_KERNEL_NAMES):
            spmv_us += us
    busy_us, reach = 0.0, float("-inf")          # union of kernel spans
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    if busy_us > 0:             # else the profiler saw no device time
        rec.update(device_ms_per_step=busy_us / 1e3 / reps,
                   device_busy_share=busy_us / 1e3 / wall_ms,
                   spmv_share_of_device=spmv_us / busy_us,
                   kernels_per_step=len(spans) / reps,
                   top_kernels=[{"name": n, "per_step": c / reps,
                                 "us_per_step": t / reps}
                                for n, (c, t) in sorted(
                                    by_name.items(),
                                    key=lambda kv: -kv[1][1])[:TOP_KERNELS]])
    log(f"[step] {label} B={b}, {cfg.n_layers} layers: "
        f"{rec['step_ms']:.2f} ms per step (host clock); device busy "
        f"{rec['device_busy_share']}, device ms/step "
        f"{rec['device_ms_per_step']}, SpMV share of device time "
        f"{rec['spmv_share_of_device']}, kernels per step "
        f"{rec['kernels_per_step']} (profiler, device kernels only)")
    for k in rec.get("top_kernels", ()):
        log(f"[step]   {k['us_per_step']:7.1f} us/step in "
            f"{k['per_step']:g} launches: {k['name']}")
    return rec


def sparse_step(ctx, cfg, params, sparse):
    from repro_torch.core.sparse_model import decode_step_sparse
    return lambda cache, batch: decode_step_sparse(
        cfg, params, sparse, cache, batch, impl=ctx["impl"],
        device=ctx["device"])


def dense_step(cfg, params):
    from repro_torch.models.transformer import decode_step
    return lambda cache, batch: decode_step(cfg, params, cache, batch)


def _nibble_pack(torch, codes):
    """int8 codes in [-8, 7] (..., Lc) -> uint8 (..., ceil(Lc/2)), slot 2j in
    the low nibble of byte j."""
    if codes.shape[-1] % 2:
        pad = torch.zeros(codes.shape[:-1] + (1,), dtype=codes.dtype,
                          device=codes.device)
        codes = torch.cat([codes, pad], dim=-1)
    u = codes.to(torch.int16) & 0xF
    return (u[..., 0::2] | (u[..., 1::2] << 4)).to(torch.uint8).contiguous()


def _dense_t(torch, pruned: dict, names, layer):
    """(in, out) bf16 weight of the group's projections, row-concatenated
    the way the pack fuses them."""
    ws = [pruned[n][layer] for n in names]
    return (ws[0] if len(ws) == 1 else torch.cat(ws, dim=1)).to(
        torch.bfloat16).contiguous()


def kernel_cases(ctx, sparse8, sparse_fp):
    """The launches each kernel makes per layer: (kernel, variant, layer,
    group, bucket, args) over the engine packs' full-width buckets."""
    torch = ctx["torch"]
    groups_mv = ("qkv", "attn_out", "down")
    cases = []
    for sparse, quant in ((sparse_fp, None), (sparse8, "int8")):
        n_layers = next(iter(sparse["groups"].values()))["buckets"][0][
            "cols"].shape[0]
        for layer in range(n_layers):
            for gname, g in sparse["groups"].items():
                glu = gname == "gateup"
                kern = {(False, None): "espim_spmv_batched",
                        (False, "int8"): "espim_spmv_batched_quant",
                        (True, None): "espim_spmv_batched_glu",
                        (True, "int8"): "espim_spmv_batched_quant_glu"}[
                            (glu, quant)]
                if not glu and gname not in groups_mv:
                    continue
                for bi, bk in enumerate(g["buckets"]):
                    cols = bk["cols"][layer]
                    if quant is None:
                        planes = {"values": bk["values"][layer]}
                    elif glu:       # only the GLU kernel reads the scales
                        planes = {"q": bk["q"][layer],
                                  "srow": bk["srow"][layer]}
                    else:
                        planes = {"q": bk["q"][layer]}
                    cases.append(dict(kernel=kern, variant=quant or "fp32",
                                      layer=layer, group=gname, bucket=bi,
                                      cols=cols, cc=g["chunk_cols"],
                                      m=g["n_cols"], **planes))
    # int4 planes for kernels 2 and 4: the int8 codes requantized to
    # [-7, 7] and nibble-packed (the plane the int4 serving path gathers);
    # bf16 planes for kernels 1 and 3: the fp32 values rounded to bf16
    extra = [dict(c, variant="bf16", values=c["values"].to(torch.bfloat16))
             for c in cases if c["variant"] == "fp32"]
    # kernel 6: the fp32 and bf16 attn_out and down buckets with a
    # packed-order residual for each checked batch
    gen = None
    for c in cases + extra:
        if (c["kernel"], c["group"]) not in (("espim_spmv_batched",
                                              "attn_out"),
                                             ("espim_spmv_batched", "down")):
            continue
        dev = c["cols"].device
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(
                ctx.get("seed", 0) + 6)
        res = {b: torch.randn((c["cols"].shape[0], b), generator=gen,
                              device=dev) for b in CHECK_BATCHES}
        extra.append(dict(c, kernel="espim_spmv_batched_res", res=res))
    for c in cases:
        if c["variant"] != "int8":
            continue
        q4 = torch.clamp(torch.round(c["q"].float() / 18.0), -7, 7).to(
            torch.int8)
        extra.append(dict(c, variant="int4", q=_nibble_pack(torch, q4)))
        if c["layer"] == 0 and c["bucket"] == 0 and c["group"] in (
                "qkv", "gateup"):
            lc = c["cols"].shape[-1] - 1                 # odd width
            extra.append(dict(c, variant="int4-oddLc",
                              cols=c["cols"][..., :lc].contiguous(),
                              q=_nibble_pack(torch, q4[..., :lc])))
    return cases + extra


def run_case(ops, c, x, impl):
    if c["kernel"] == "espim_spmv_batched":
        return ops.espim_spmv_batched(c["values"], c["cols"], x,
                                      chunk_cols=c["cc"], impl=impl)
    if c["kernel"] == "espim_spmv_batched_res":
        return ops.espim_spmv_batched(c["values"], c["cols"], x,
                                      chunk_cols=c["cc"], impl=impl,
                                      epilogue="residual",
                                      residual=c["res"][x.shape[1]])
    if c["kernel"] == "espim_spmv_batched_glu":
        return ops.espim_spmv_batched(c["values"], c["cols"], x,
                                      chunk_cols=c["cc"], impl=impl,
                                      epilogue="glu", act="silu")
    if c["kernel"] == "espim_spmv_batched_quant":
        return ops.espim_spmv_batched_quant(c["q"], c["cols"], None, x,
                                            chunk_cols=c["cc"], impl=impl)
    return ops.espim_spmv_batched_quant(c["q"], c["cols"], None, x,
                                        chunk_cols=c["cc"], impl=impl,
                                        epilogue="glu", act="silu",
                                        srow=c["srow"])


def case_bytes(c, b: int) -> tuple[int, int]:
    """(bytes, flops) the launch needs: every plane it reads read once
    (values or codes, cols, and the GLU kernel's scales), x and the
    residual read once, the output written once."""
    plane = sum(c[k].numel() * c[k].element_size()
                for k in ("values", "q", "srow", "cols") if k in c)
    slots = c["cols"].numel()
    rows_out = c["cols"].shape[0] // (2 if "glu" in c["kernel"] else 1)
    res = rows_out * b * 4 if "res" in c else 0
    return plane + c["m"] * b * 4 + rows_out * b * 4 + res, 2 * slots * b


def bucket_times(ctx, sel, xs, b) -> list:
    """Device µs of each launch in ``sel`` at batch ``b`` on its own: the
    ``Timer`` of a graph that reads a 128 MB buffer (evicting the 50 MB L2,
    as the layer's other launches do) and then makes the launch, less the
    read's own time; with the launch's shape and the GB/s of its bytes
    (``case_bytes``)."""
    from repro_torch.kernels import ops
    torch, timer = ctx["torch"], ctx["timer"]
    flush = torch.ones(32 << 20, device=ctx["device"])
    t_flush = timer(flush.sum)
    out = []
    for c in sel:
        x = xs[(c["m"], b)]
        t = timer(lambda c=c, x=x: (flush.sum(),
                                    run_case(ops, c, x, ctx["impl"])))
        us = (t - t_flush) * 1e3
        nbytes = case_bytes(c, b)[0]
        rows, k, lc = c["cols"].shape
        out.append({"kernel": c["kernel"], "variant": c["variant"], "B": b,
                    "layer": c["layer"], "group": c["group"],
                    "bucket": c["bucket"], "rows": rows, "K": k, "Lc": lc,
                    "us": us, "bytes": nbytes,
                    "GBps": nbytes / (us * 1e-6) / 1e9})
    return out


def phase_kernels(ctx, sparse8, sparse_fp, launches_main) -> list:
    """Every kernel against its plain version (and against itself: two
    launches on the same inputs must give the same bits), then timed.  The
    launches made here are comparisons: the line reports the engine runs'
    counts (``launches_main``)."""
    from repro_torch.kernels import ops
    torch, dev, timer = ctx["torch"], ctx["device"], ctx["timer"]
    bw = ctx["bandwidth"]
    cases = kernel_cases(ctx, sparse8, sparse_fp)
    gen = torch.Generator(device=dev).manual_seed(ctx["seed"] + 2)
    xs = {(m, b): torch.randn((m, b), generator=gen, device=dev)
          for m in {c["m"] for c in cases} for b in CHECK_BATCHES}
    # 1) correctness: every case at every batch tile and its remainders
    worst = dict.fromkeys((c["kernel"] for c in cases), 0.0)
    rows = []
    for c in cases:
        for b in CHECK_BATCHES:
            x = xs[(c["m"], b)]
            got = run_case(ops, c, x, ctx["impl"])
            again = run_case(ops, c, x, ctx["impl"])
            want = run_case(ops, c, x, "ref")
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            what = (f"{c['kernel']} {c['variant']} {c['group']}/"
                    f"b{c['bucket']} B={b}")
            need(got.shape == want.shape and bool(torch.isfinite(got).all()),
                 f"{what}: bad output")
            need(torch.equal(got, again), f"{what}: two launches on the "
                 "same inputs gave different bits")
            need(err <= KERNEL_REL_TOL * scale + KERNEL_ABS_TOL,
                 f"{what}: max|kernel-plain| {err:.3e} > "
                 f"{KERNEL_REL_TOL}*{scale:.3e}+{KERNEL_ABS_TOL}")
            worst[c["kernel"]] = max(worst[c["kernel"]], err)
            rows.append({"kernel": c["kernel"], "variant": c["variant"],
                         "layer": c["layer"], "group": c["group"],
                         "bucket": c["bucket"],
                         "shape": list(c["cols"].shape), "B": b,
                         "max_abs_err": err, "max_abs_plain": scale})
    log(f"[kernels] {len(rows)} checks within {KERNEL_REL_TOL}*max|plain| + "
        f"{KERNEL_ABS_TOL}, each bit-identical across two launches; worst "
        "max|kernel-plain| "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    ctx["worst"] = worst
    # 2) timing: per kernel and variant, one layer's launches at B in {1,4},
    # cycling over every layer so the planes stream from HBM (the packs
    # of all layers exceed the 50 MB L2); kernel 6 is timed per call,
    # beside its addmm, by phase_new_kernels
    timed = {}
    for key in sorted({(c["kernel"], c["variant"]) for c in cases
                       if c["variant"] != "int4-oddLc"
                       and c["kernel"] != "espim_spmv_batched_res"}):
        sel = [c for c in cases if (c["kernel"], c["variant"]) == key]
        n_layers = len({c["layer"] for c in sel})
        src = sparse_fp if key[1] in ("fp32", "bf16") else sparse8
        for b in TIME_BATCHES:
            def launch_all(impl, sel=sel, b=b):
                for c in sel:
                    run_case(ops, c, xs[(c["m"], b)], impl)
            t_k = timer(lambda: launch_all(ctx["impl"])) / n_layers
            t_p = timer(lambda: launch_all("ref"), reps=3) / n_layers
            nbytes = sum(case_bytes(c, b)[0] for c in sel) / n_layers
            flops = sum(case_bytes(c, b)[1] for c in sel) / n_layers
            t_bytes, t_ops = nbytes / bw * 1e3, flops / PEAKS["fp32"] * 1e3
            # library: dense bf16 matmul of the same pruned (dequantized)
            # matrices, one call per group and layer
            mats = []
            for layer in range(n_layers):
                for gname in sorted({c["group"] for c in sel}):
                    g = src["groups"][gname]
                    xb = xs[(g["n_cols"], b)].T.to(torch.bfloat16).contiguous()
                    mats.append((xb, _dense_t(torch, src["pruned"],
                                              g["projections"], layer)))
            t_lib = timer(lambda: [torch.matmul(a, w) for a, w in mats]
                          ) / n_layers
            timed[(key, b)] = {
                "kernel": key[0], "variant": key[1], "B": b,
                "launches_per_layer": len(sel) // n_layers,
                "ms": t_k, "plain_ms": t_p, "library_ms": t_lib,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops,
                "achieved_GBps": nbytes / (t_k * 1e-3) / 1e9}
            r = timed[(key, b)]
            log(f"[kernels] {key[0]:30s} {key[1]:5s} B={b}: "
                f"{r['launches_per_layer']} launches/layer "
                f"{t_k * 1e3:8.1f} us (plain {t_p * 1e3:9.1f} us, "
                f"bf16 matmul {t_lib * 1e3:7.1f} us, bound "
                f"{r['bound_ms'] * 1e3:6.1f} us by {r['bound_by']}; "
                f"{nbytes / 1e6:.1f} MB, {r['achieved_GBps']:.0f} GB/s)")
    # the line's entry per kernel: its main-path variant at B = 4
    main_variant = {"espim_spmv_batched": "fp32",
                    "espim_spmv_batched_glu": "fp32",
                    "espim_spmv_batched_quant": "int8",
                    "espim_spmv_batched_quant_glu": "int8"}
    # 3) per bucket launch of kernels 1-4 and 6 at B = 4: does a small
    # bucket under-fill the card?
    per_bucket = []
    bucket_variant = dict(main_variant, espim_spmv_batched_res="fp32")
    for name in STREAM_KERNELS:
        sel = [c for c in cases if c["kernel"] == name
               and c["variant"] == bucket_variant[name]]
        per_bucket += bucket_times(ctx, sel, xs, 4)
    for r in per_bucket:
        log(f"[buckets] {r['kernel']:28s} {r['variant']:4s} B={r['B']} "
            f"layer {r['layer']} {r['group']:8s}/b{r['bucket']} rows "
            f"{r['rows']:5d} K {r['K']:2d} Lc {r['Lc']:3d}: "
            f"{r['us']:7.1f} us, {r['GBps']:5.0f} GB/s")
    ctx["report"]["bucket_timing"] = per_bucket
    entries = []
    for name, variant in main_variant.items():
        r = timed[((name, variant), 4)]
        entries.append(_entry(name, launches_main[name], worst[name], r))
    ctx["report"]["kernel_checks"] = rows
    ctx["report"]["kernel_timing"] = list(timed.values())
    return entries


def _entry(name: str, launches: int, err: float, r: dict) -> dict:
    replaces, fn, source = _KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": f"{replaces} ({fn})", "launches": launches,
            "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]}


# --------------------------------------------------------------------------
# the projection path and the ops of kernels 5-8
# --------------------------------------------------------------------------
def dense_from_weights(torch, w):
    """The (n_rows, n_cols) fp32 matrix a device pack holds — the codes
    times their scales for a quantized pack — scattered back from the
    planes through ``perm``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import nibble_unpack_ref
    vals = w.values
    r, k, lc = w.cols.shape
    if isinstance(w, ops.QuantEspimWeights):
        if vals.shape[-1] != lc:
            vals = nibble_unpack_ref(vals)[..., :lc]
        srow = torch.repeat_interleave(w.scales, w.group_rows)[:r]
        vals = vals.float() * srow[:, None, None]
    vals = vals.float()
    dev = vals.device
    gcol = (w.cols.long()
            + (torch.arange(k, device=dev) * w.chunk_cols)[None, :, None])
    rows = w.perm.long()[:, None, None].expand(r, k, lc)
    keep = (rows >= 0) & (vals != 0)
    dense = torch.zeros((w.n_rows, w.n_cols), dtype=torch.float32,
                        device=dev)
    return dense.index_put_((rows[keep], gcol[keep]), vals[keep],
                            accumulate=True)


def rel_l2(got, want) -> float:
    """||got - want||_2 / ||want||_2 over the whole output."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _within(kernel: str, variant: str, got, want) -> tuple[bool, float]:
    """(passes, max|got - want|) under the kernel's stated tolerances."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    key = f"{kernel}/{variant.split()[0]}"
    tol = ALLCLOSE_TOL.get(key)
    if tol is not None:
        ok = bool((diff <= tol + tol * want.abs()).all())
    else:
        ok = err <= KERNEL_REL_TOL * float(want.abs().max()) + KERNEL_ABS_TOL
    if key in REL_L2_TOL:
        ok = ok and rel_l2(got, want) <= REL_L2_TOL[key]
    return (ok and got.shape == want.shape
            and bool(got.isfinite().all())), err


def phase_projection(ctx, params) -> dict:
    """The standalone projection layers at full width: ESPIMGroupLinear
    over layer 0's wq/wk/wv (3 x 4096 x 4096) and ESPIMLinear over its
    w_down (4096 x 11008), 90% sparse, fp32 and int8; each called with a
    1-D x and with (4, n_in), against ``impl="ref"`` and the dense pruned
    (dequantized) fp32 product; then the dense datapath once.  Launch
    counters are zeroed before the calls and read after."""
    from repro_torch.core.espim_linear import ESPIMGroupLinear, ESPIMLinear
    from repro_torch.core.pruning import magnitude_prune
    import numpy as np
    torch, dev = ctx["torch"], ctx["device"]
    qkv = ("wq", "wk", "wv")
    attn, mlp = params["layers"]["attn"], params["layers"]["mlp"]
    # (n_out, n_in) float32 host copies of layer 0's weights
    host = {n: attn[n][0].T.float().cpu().numpy() for n in qkv}
    host["w_down"] = mlp["w_down"][0].T.float().cpu().numpy()
    t0 = time.perf_counter()
    layers = {}
    for quant in (None, "int8"):
        v = quant or "fp32"
        layers[("qkv", v)] = ESPIMGroupLinear.from_dense(
            {n: host[n] for n in qkv}, prune_sparsity=PROJ_SPARSITY,
            quant=quant, device=dev)
        layers[("down", v)] = ESPIMLinear.from_dense(
            host["w_down"], prune_sparsity=PROJ_SPARSITY, quant=quant,
            device=dev)
    pack_s = time.perf_counter() - t0
    pruned = {"qkv": np.concatenate([magnitude_prune(host[n], PROJ_SPARSITY)
                                     for n in qkv]),
              "down": magnitude_prune(host["w_down"], PROJ_SPARSITY)}
    dense = {}
    for (name, v), layer in layers.items():
        dense[(name, v)] = dense_from_weights(torch, layer.weights)
        if v == "fp32":     # the fp32 planes hold the pruned matrix exactly
            want = torch.from_numpy(pruned[name]).to(dev)
            need(torch.equal(dense[(name, v)], want),
                 f"[proj] {name} fp32 planes != the pruned matrix")
    gen = torch.Generator(device=dev).manual_seed(ctx["seed"] + 4)
    checks = []
    reset_launches()
    for (name, v), layer in layers.items():
        for shape in ((layer.n_in,), (4, layer.n_in)):
            x = torch.randn(shape, generator=gen, device=dev)
            outs = [layer(x), layer(x, impl="ref")]
            if name == "qkv":
                outs = [torch.cat([o[n] for n in qkv], dim=-1) for o in outs]
            got, plain = outs
            prod = x @ dense[(name, v)].T
            for what, want in (("plain", plain), ("dense", prod)):
                ok, err = _within("projection", v, got, want)
                need(ok, f"[proj] {name} {v} x{tuple(shape)}: "
                     f"max|layer - {what}| {err:.3e} out of tolerance")
                checks.append({"layer": name, "variant": v,
                               "x": list(shape), "against": what,
                               "max_abs_err": err,
                               "max_abs_want": float(want.abs().max())})
    before = read_launches()
    dense_layer = ESPIMLinear.from_dense(host["w_down"], device=dev)
    x = torch.randn((dense_layer.n_in,), generator=gen, device=dev)
    y = dense_layer(x)
    need(not dense_layer.sparse,
         f"[proj] the unpruned w_down (density {dense_layer.density}) did "
         f"not take the dense datapath")
    need(read_launches() == before, "[proj] the dense datapath launched a "
         "kernel")
    ok, err = _within("projection", "fp32", y,
                      dense_layer.weight @ x)
    need(ok, f"[proj] dense datapath max err {err:.3e}")
    launches = read_launches()
    for k in ("espim_spmv", "espim_spmv_batched",
              "espim_spmv_batched_quant"):
        need(launches[k] > 0, f"[proj] kernel {k} never launched")
    worst = max(c["max_abs_err"] / c["max_abs_want"] for c in checks)
    g, d = layers[("qkv", "fp32")], layers[("down", "fp32")]
    log(f"[proj] ESPIMGroupLinear qkv {'+'.join(map(str, g.sizes))}x"
        f"{g.n_in} + ESPIMLinear down {d.n_out}x{d.n_in} at "
        f"{PROJ_SPARSITY:.0%} sparsity, fp32 and int8, "
        f"packed on the host in {pack_s:.1f} s; {len(checks)} checks "
        f"(1-D and (4, n_in) x, vs impl='ref' and the dense product), worst "
        f"max|diff|/max|want| {worst:.2e}; dense datapath at density "
        f"{dense_layer.density:.7f} ok; launches "
        + ", ".join(f"{k} {n}" for k, n in launches.items() if n))
    ctx["report"]["projection"] = {"pack_seconds": pack_s, "checks": checks,
                                   "launches": launches,
                                   "dense_density": dense_layer.density}
    return {"launches": launches, "layers": layers,
            "dense": {n: dense[(n, "fp32")] for n in ("qkv", "down")}}


# --------------------------------------------------------------------------
# the dense serving mode and the fault ladder's dense rungs
# --------------------------------------------------------------------------
def _cast_tree(tree: dict, **to) -> dict:
    return {k: (_cast_tree(v, **to) if isinstance(v, dict) else v.to(**to))
            for k, v in tree.items()}


def _roll(torch, cfg, params, toks, device):
    """Teacher-forced dense decode of ``toks`` (B, S) from an empty cache
    -> float32 logits (B, S, V)."""
    from repro_torch.models.transformer import decode_step, init_cache
    cache = init_cache(cfg, toks.shape[0], toks.shape[1] + 4, device=device)
    outs = []
    for s in range(toks.shape[1]):
        lg, cache = decode_step(cfg, params, cache,
                                {"tokens": toks[:, s:s + 1].to(device)})
        outs.append(lg[:, 0].float())
    return torch.stack(outs, 1)


def dense_parity(ctx, cfg, params, cfg_fp, params_fp, steps=4, b=4) -> dict:
    """Teacher-forced dense decode at B = 4 on the card against the CPU, in
    fp32 (the fp engine's 1-layer config, its params cast to fp32); then
    the int8 KV cache against the bf16 one on the card (the 2-layer bf16
    model, 8 steps)."""
    torch, dev = ctx["torch"], ctx["device"]
    gen = torch.Generator().manual_seed(ctx["seed"] + 7)
    toks = torch.randint(0, cfg.vocab_size, (b, 2 * steps), generator=gen,
                         dtype=torch.int32)
    cfg32 = cfg_fp.replace(param_dtype="float32", compute_dtype="float32")
    p32 = _cast_tree(params_fp, dtype=torch.float32)
    card = _roll(torch, cfg32, p32, toks[:, :steps], dev).cpu()
    cpu = _roll(torch, cfg32, _cast_tree(p32, device="cpu"),
                toks[:, :steps], "cpu")
    del p32
    err = float((card - cpu).abs().max())
    scale = float(cpu.abs().max())
    need(bool(torch.isfinite(card).all())
         and err <= DENSE_LOGIT_REL_TOL * scale,
         f"[dense] card vs CPU fp32 logits max|diff| {err:.3e} > "
         f"{DENSE_LOGIT_REL_TOL}*{scale:.3e}")
    lg16 = _roll(torch, cfg, params, toks, dev)
    lg8 = _roll(torch, cfg.replace(kv_cache_dtype="int8"), params, toks, dev)
    kv_err = float((lg8 - lg16).abs().max() / lg16.abs().max())
    need(0 < kv_err < KV_QUANT_REL_TOL,
         f"[dense] int8-KV vs bf16-KV logits max|diff|/max|bf16| "
         f"{kv_err:.3e} not in (0, {KV_QUANT_REL_TOL})")
    log(f"[dense] {steps} teacher-forced steps B={b}, fp32 "
        f"{cfg32.n_layers} layer, card vs CPU: max|diff| {err:.3e} "
        f"(<= {DENSE_LOGIT_REL_TOL} * max|cpu| {scale:.3f}); int8 vs bf16 "
        f"KV, {cfg.n_layers} layers, {2 * steps} steps on the card: "
        f"max|diff|/max|bf16| {kv_err:.3e} (< {KV_QUANT_REL_TOL})")
    return {"card_vs_cpu_max_abs": err, "cpu_max_abs": scale,
            "int8_vs_bf16_kv_rel": kv_err}


def _clone_groups(sparse: dict) -> tuple[dict, dict]:
    """A structural copy of a sparse dict (the tensors shared) and its
    first group's first bucket, for one plane to be swapped."""
    out = dict(sparse)
    out["groups"] = {n: dict(g, buckets=[dict(b) for b in g["buckets"]])
                     for n, g in sparse["groups"].items()}
    out.update(out["groups"])
    return out, out["groups"][next(iter(out["groups"]))]["buckets"][0]


def _need_clean_finish(label, eng, reqs) -> None:
    for r in reqs:
        need(len(r.output) == MAX_NEW,
             f"[{label}] request {r.rid} produced {len(r.output)} tokens")
    need(eng.stats.requests_completed == len(reqs)
         and eng.stats.requests_failed == 0,
         f"[{label}] {eng.stats.requests_completed} completed, "
         f"{eng.stats.requests_failed} failed of {len(reqs)}")
    eng.check_arena()
    need(eng.cache.free_blocks == eng.cache.num_blocks,
         f"[{label}] {eng.cache.num_blocks - eng.cache.free_blocks} blocks "
         "leaked")


def quarantine_drill(ctx, cfg, params, sparse8, prompts, baseline) -> dict:
    """The int8 engine with its decode closure swapped at tick 5 for one
    over a copy of the packs whose first retained row scale is NaN (the
    engine's own packs stay clean): every poisoned slot is quarantined and
    finishes on the dense fallback over the pruned copy."""
    import numpy as np

    from repro_torch.serve import engine as E
    from repro_torch.serve.serve_step import serve_step_sparse_fn
    bad, bk = _clone_groups(sparse8)
    cell = tuple(int(i) for i in np.argwhere(np.asarray(bk["valid"]))[0])
    srow = bk["srow"].clone()
    srow[cell[:2]] = float("nan")
    bk["srow"] = srow
    eng = E.ServeEngine(cfg, params, sparse=sparse8, device=ctx["device"],
                        **ENGINE_KW)

    def poison(e):
        e._decode = E._finite_step(
            lambda p, c, b: serve_step_sparse_fn(
                cfg, p, bad, c, b, temperature=e.temperature,
                impl=ctx["impl"], generator=e._gen, device=e.device))

    reqs, _, wall = serve(E, eng, prompts, MAX_NEW, inject=(5, poison))
    _need_clean_finish("quarantine", eng, reqs)
    st = eng.stats
    need(st.quarantines >= 1 and st.degraded_tokens >= 1,
         f"[quarantine] {st.quarantines} quarantines, "
         f"{st.degraded_tokens} degraded tokens")
    agree = sum(a == b for r, base in zip(reqs, baseline)
                for a, b in zip(r.output, base))
    states = st.latency_summary()["states"]
    log(f"[quarantine] poison at tick 5: {st.quarantines} quarantines, "
        f"{st.degraded_tokens} of {st.tokens_generated} tokens from the "
        f"dense fallback, states {states}, 0 failed, arena clean; "
        f"{agree}/{st.tokens_generated} tokens equal the no-fault run's; "
        f"{wall:.2f} s")
    return {"quarantines": st.quarantines,
            "degraded_tokens": st.degraded_tokens,
            "tokens": st.tokens_generated, "states": states,
            "tokens_equal_no_fault": agree, "wall_s": wall}


def degrade_at_load(ctx, cfg, params, sparse8, prompts) -> dict:
    """One bit flipped in a value plane: the default engine refuses the
    packs, and ``on_verify_failure="degrade"`` serves the pruned dense
    copy, launching no ESPIM kernel."""
    from repro_torch.core.integrity import PackIntegrityError
    from repro_torch.serve import engine as E
    torch = ctx["torch"]
    bad, bk = _clone_groups(sparse8)
    q = bk["q"].clone()
    flat = q.view(torch.uint8).view(-1)
    flat[0] = flat[0] ^ 1
    bk["q"] = q
    try:
        E.ServeEngine(cfg, params, sparse=bad, device=ctx["device"],
                      **ENGINE_KW)
        raised = False
    except PackIntegrityError:
        raised = True
    need(raised, "[degrade] a flipped code bit passed pack verification")
    eng = E.ServeEngine(cfg, params, sparse=bad, device=ctx["device"],
                        on_verify_failure="degrade", **ENGINE_KW)
    need(eng.sparse is None and eng.stats.degraded_to_dense,
         "[degrade] the engine did not fall back to the dense copy")
    reset_launches()
    reqs, _, wall = serve(E, eng, prompts, MAX_NEW)
    launches = read_launches()
    need(not any(launches.values()),
         f"[degrade] the degraded engine launched kernels {launches}")
    _need_clean_finish("degrade", eng, reqs)
    log(f"[degrade] flipped code bit: PackIntegrityError by default; with "
        f"on_verify_failure='degrade' {len(reqs)} requests served dense in "
        f"{wall:.2f} s, no kernel launched, arena clean")
    return {"requests": len(reqs), "wall_s": wall}


def _fmt(x, spec: str, unit: str = "") -> str:
    return "not measured" if x is None else format(x, spec) + unit


def phase_dense(ctx, cfg, params, cfg_fp, params_fp, sparse8, prompts,
                eng8) -> None:
    """The dense engine (bf16 and int8 KV) over the unpruned params, its
    step beside the int8 sparse step, card-vs-CPU parity, then the
    quarantine drill and degrade at load."""
    report = ctx["report"]
    rec = {"engine": {kv: drive_engine(
        ctx, f"dense {kv} KV", cfg.replace(kv_cache_dtype=kv), params, None,
        prompts, ()) for kv in ("bfloat16", "int8")}}
    rec["parity"] = dense_parity(ctx, cfg, params, cfg_fp, params_fp)
    steps = {("sparse", 4): report["decode_step"]}
    for b in (4, 1):
        steps[("dense", b)] = decode_step_profile(
            ctx, "decode_step dense bf16", cfg, dense_step(cfg, params), b=b)
    steps[("sparse", 1)] = decode_step_profile(
        ctx, "decode_step_sparse int8", cfg,
        sparse_step(ctx, cfg, params, sparse8), b=1)
    rec["steps"] = {f"{k} B={b}": r for (k, b), r in steps.items()}
    parts = []
    for b in (1, 4):
        sp, de = steps[("sparse", b)], steps[("dense", b)]
        parts.append(
            f"B={b}: host {sp['step_ms']:.2f} vs {de['step_ms']:.2f} ms, "
            f"device {_fmt(sp['device_ms_per_step'], '.3f', ' ms')} vs "
            f"{_fmt(de['device_ms_per_step'], '.3f', ' ms')}, busy "
            f"{_fmt(sp['device_busy_share'], '.1%')} vs "
            f"{_fmt(de['device_busy_share'], '.1%')}, kernels "
            f"{_fmt(sp['kernels_per_step'], 'g')} vs "
            f"{_fmt(de['kernels_per_step'], 'g')}")
    dense16 = rec["engine"]["bfloat16"]
    log(f"[sparse-vs-dense] int8 sparse vs dense bf16 step, {cfg.n_layers} "
        f"layers, cache 32: " + "; ".join(parts)
        + f"; engine TPOT p50 {eng8['tpot_p50_s'] * 1e3:.2f} vs "
        f"{dense16['tpot_p50_s'] * 1e3:.2f} ms, {eng8['tok_per_s']:.1f} vs "
        f"{dense16['tok_per_s']:.1f} tok/s")
    rec["quarantine"] = quarantine_drill(ctx, cfg, params, sparse8, prompts,
                                         eng8["outputs"])
    rec["degrade"] = degrade_at_load(ctx, cfg, params, sparse8, prompts[:4])
    report["dense"] = rec


def new_kernel_cases(ctx, proj, sparse_fp) -> list:
    """Timing groups of kernels 5-8: (kernel, variant, cases), each case
    {"run": impl -> tensor, "library": () -> tensor, "bytes", "flops",
    "peak"} at the shapes the projection phase and the ops give them."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    torch, dev = ctx["torch"], ctx["device"]
    gen = torch.Generator(device=dev).manual_seed(ctx["seed"] + 5)
    bf = torch.bfloat16
    groups = []
    # kernel 5: the projection packs with a 1-D x, fp32 and bf16
    for dt, label in ((torch.float32, "fp32"), (bf, "bf16")):
        cases = []
        for name in ("qkv", "down"):
            w = proj["layers"][(name, "fp32")].weights
            vals = w.values.to(dt)
            x = torch.randn((w.n_cols,), generator=gen, device=dev).to(dt)
            wb = proj["dense"][name].to(bf)
            xb = x.to(bf)
            cases.append({
                "run": (lambda impl, v=vals, c=w.cols, x=x, cc=w.chunk_cols:
                        ops.espim_spmv(v, c, x, chunk_cols=cc, impl=impl)),
                "library": lambda wb=wb, xb=xb: torch.matmul(wb, xb),
                "bytes": (vals.numel() * vals.element_size()
                          + w.cols.numel() * 4 + x.numel() * x.element_size()
                          + w.cols.shape[0] * 4),
                "flops": 2 * w.cols.numel(), "peak": "fp32"})
        groups.append(("espim_spmv", label, cases))
    # kernel 6: the fp32 engine's attn_out and down buckets + residual; at
    # B = 4 also on their values cast to bf16
    for b, dt in ((1, torch.float32), (4, torch.float32), (4, bf)):
        cases = []
        for gname in ("attn_out", "down"):
            g = sparse_fp["groups"][gname]
            x = torch.randn((g["n_cols"], b), generator=gen, device=dev)
            wb = _dense_t(torch, sparse_fp["pruned"], g["projections"], 0)
            xb = x.T.to(bf).contiguous()
            rb = torch.randn((b, wb.shape[1]), generator=gen,
                             device=dev).to(bf)
            for bi, bk in enumerate(g["buckets"]):
                vals, cols = bk["values"][0].to(dt), bk["cols"][0]
                res = torch.randn((cols.shape[0], b), generator=gen,
                                  device=dev)
                cases.append({
                    "run": (lambda impl, v=vals, c=cols, x=x, r=res,
                            cc=g["chunk_cols"]:
                            ops.espim_spmv_batched(
                                v, c, x, chunk_cols=cc, impl=impl,
                                epilogue="residual", residual=r)),
                    # one call per group: the first bucket carries it
                    "library": ((lambda rb=rb, xb=xb, wb=wb:
                                 torch.addmm(rb, xb, wb)) if bi == 0
                                else None),
                    "bytes": (vals.numel() * vals.element_size()
                              + cols.numel() * 4 + x.numel() * 4
                              + 2 * res.numel() * 4),
                    "flops": 2 * cols.numel() * b, "peak": "fp32"})
        groups.append(("espim_spmv_batched_res",
                       f"{'bf16' if dt == bf else 'fp32'} B={b}", cases))
    # kernel 7: dense MV
    for r, c in DENSE_SHAPES:
        for dt, label in ((torch.float32, "fp32"), (bf, "bf16")):
            w = torch.randn((r, c), generator=gen, device=dev).to(dt)
            x = torch.randn((c,), generator=gen, device=dev).to(dt)
            groups.append(("dense_mv", f"{label} {r}x{c}", [{
                "run": lambda impl, w=w, x=x: ops.dense_mv(w, x, impl=impl),
                "library": lambda w=w, x=x: torch.mv(w, x),
                "bytes": (w.numel() + x.numel()) * w.element_size() + r * 4,
                "flops": 2 * r * c, "peak": "fp32"}]))
    # kernel 8: flash attention
    shapes = ([(seq, FLASH_HD) for seq in FLASH_SEQS]
              + [(FLASH_RAGGED_SEQ, hd) for hd in FLASH_OTHER_HDS])
    for seq, hd in shapes:
        for causal in (True, False):
            for dt, label in ((torch.float32, "fp32"), (bf, "bf16")):
                q, k, v = (torch.randn((FLASH_BH, seq, hd),
                                       generator=gen, device=dev).to(dt)
                           for _ in range(3))
                pairs = seq * (seq + 1) // 2 if causal else seq * seq
                groups.append((
                    "flash_attention",
                    f"{label} S={seq} {'causal' if causal else 'full'}"
                    + ("" if hd == FLASH_HD else f" hd={hd}"), [{
                        "run": (lambda impl, q=q, k=k, v=v, cz=causal:
                                flash_attention(q, k, v, causal=cz,
                                                impl=impl)),
                        # (1, BH, S, hd): SDPA's fused backends take 4-D
                        "library": (lambda q=q, k=k, v=v, cz=causal:
                                    F.scaled_dot_product_attention(
                                        q[None], k[None], v[None],
                                        is_causal=cz)),
                        "bytes": 4 * q.numel() * q.element_size(),
                        "flops": 4 * FLASH_BH * hd * pairs,
                        "peak": "tf32x3_tensor" if label == "fp32"
                        else "bf16_tensor"}]))
    return groups


def phase_ops(ctx, groups) -> dict:
    """Drive kernels 6-8 through their ops once per case (the entry point
    a caller uses: ``ops.espim_spmv_batched(epilogue="residual")``,
    ``ops.dense_mv``, ``flash_attention``), counters zeroed just before
    and read just after."""
    torch = ctx["torch"]
    reset_launches()
    n = 0
    for kernel, variant, cases in groups:
        if kernel == "espim_spmv":
            continue
        for c in cases:
            out = c["run"](None)
            need(bool(out.isfinite().all()),
                 f"[ops] {kernel} {variant}: non-finite output")
            n += 1
    torch.cuda.synchronize()
    launches = read_launches()
    for k in ("espim_spmv_batched_res", "dense_mv", "flash_attention"):
        need(launches[k] > 0, f"[ops] kernel {k} never launched")
    log(f"[ops] {n} op calls; launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
    ctx["report"]["ops"] = {"calls": n, "launches": launches}
    return launches


def phase_new_kernels(ctx, groups, launches_main) -> list:
    """Kernels 5-8 against their plain versions (and against themselves:
    two launches on the same inputs must give the same bits), then timed
    beside the plain version, the library call and the bound."""
    torch, timer, bw = ctx["torch"], ctx["timer"], ctx["bandwidth"]
    worst, rows, timed = dict(ctx.get("worst", {})), [], []
    for kernel, variant, cases in groups:
        for i, c in enumerate(cases):
            got, again = c["run"](None), c["run"](None)
            want = c["run"]("ref")
            ok, err = _within(kernel, variant, got, want)
            rel = rel_l2(got, want)
            need(ok, f"{kernel} {variant} case {i}: max|kernel-plain| "
                 f"{err:.3e}, rel L2 {rel:.3e}: out of tolerance")
            need(torch.equal(got, again), f"{kernel} {variant} case {i}: "
                 "two launches on the same inputs gave different bits")
            worst[kernel] = max(worst.get(kernel, 0.0), err)
            if kernel == "flash_attention":
                log(f"[kernels] flash_attention {variant}: max|kernel-plain| "
                    f"{err:.3e}, rel L2 {rel:.3e}")
            rows.append({"kernel": kernel, "variant": variant, "case": i,
                         "shape": list(got.shape), "max_abs_err": err,
                         "rel_l2": rel,
                         "max_abs_plain": float(want.float().abs().max())})
        t_k = timer(lambda cases=cases: [c["run"](None) for c in cases])
        t_p = timer(lambda cases=cases: [c["run"]("ref") for c in cases],
                    reps=3)
        t_lib = timer(lambda cases=cases: [c["library"]() for c in cases
                                           if c["library"]])
        nbytes = sum(c["bytes"] for c in cases)
        t_bytes = nbytes / bw * 1e3
        t_ops = sum(c["flops"] / PEAKS[c["peak"]] for c in cases) * 1e3
        r = {"kernel": kernel, "variant": variant,
             "launches_per_call": len(cases), "ms": t_k, "plain_ms": t_p,
             "library_ms": t_lib, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "peak": cases[0]["peak"], "bytes": nbytes,
             "flops": sum(c["flops"] for c in cases),
             "achieved_GBps": nbytes / (t_k * 1e-3) / 1e9,
             "achieved_TFLOPs": sum(c["flops"] for c in cases)
             / (t_k * 1e-3) / 1e12}
        timed.append(r)
        log(f"[kernels] {kernel:22s} {variant:22s}: {len(cases)} launches "
            f"{t_k * 1e3:9.1f} us (plain {t_p * 1e3:9.1f} us, library "
            f"{t_lib * 1e3:8.1f} us, bound {r['bound_ms'] * 1e3:7.1f} us by "
            f"{r['bound_by']} at the {r['peak']} peak; "
            f"{r['achieved_GBps']:.0f} GB/s, "
            f"{r['achieved_TFLOPs']:.2f} TFLOP/s)")
    main_variant = {"espim_spmv": "fp32",
                    "espim_spmv_batched_res": "fp32 B=4",
                    # w_down's shape, 4096 x 11008
                    "dense_mv": "fp32 {}x{}".format(*DENSE_SHAPES[1]),
                    "flash_attention": f"bf16 S={FLASH_SEQS[-1]} causal"}
    log(f"[kernels] kernels 5-8: {len(rows)} checks within their "
        f"tolerances, each bit-identical across two launches; worst "
        f"max|kernel-plain| "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()
                    if k in main_variant))
    by_key = {(r["kernel"], r["variant"]): r for r in timed}
    ctx["report"]["kernel_checks"] += rows
    ctx["report"]["kernel_timing"] += timed
    return [_entry(k, launches_main[k], worst[k], by_key[(k, v)])
            for k, v in main_variant.items()]


def run(ctx) -> list:
    """All phases after the build; returns the kernels line's entries."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.sparse_model import sparse_stats, sparsify_model
    from repro_torch.models.factory import init_params
    torch, dev, report = ctx["torch"], ctx["device"], ctx["report"]
    cfg = get_config(ARCH).replace(n_layers=N_LAYERS_INT8)
    log(f"[model] {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.param_dtype}; "
        f"{cfg.n_layers} layers (depth cut), sparsity {cfg.espim_sparsity}")
    gen = torch.Generator(device=dev).manual_seed(ctx["seed"])
    params = init_params(cfg, gen, device=dev)
    t0 = time.perf_counter()
    sparse8 = sparsify_model(cfg, params, cfg.espim_sparsity,
                             projections="all", quant="int8", device=dev)
    pack_s = time.perf_counter() - t0
    st = sparse_stats(sparse8)["total"]
    report["pack_int8"] = {"seconds": pack_s, "layers": cfg.n_layers, **st}
    log(f"[pack] int8 {cfg.n_layers} layers in {pack_s:.1f} s: per layer "
        f"value {st['value_plane_bytes'] / cfg.n_layers / 1e6:.1f} MB + "
        f"index {st['index_plane_bytes'] / cfg.n_layers / 1e6:.1f} MB, "
        f"padded slots {st['pad_frac']:.3f}")
    for gname, g in sparse8["groups"].items():
        log(f"[pack]   {gname}: buckets "
            + ", ".join(str(tuple(b["cols"].shape[1:])) for b in g["buckets"]))

    cfg_fp = cfg.replace(n_layers=N_LAYERS_FP)
    params_fp = layer_slice(params, N_LAYERS_FP)
    t0 = time.perf_counter()
    sparse_fp = sparsify_model(cfg_fp, params_fp, cfg.espim_sparsity,
                               projections="all", quant=None, device=dev)
    report["pack_fp"] = {"seconds": time.perf_counter() - t0,
                         "layers": N_LAYERS_FP}

    rng = torch.Generator().manual_seed(ctx["seed"] + 3)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in PROMPT_LENS]
    eng8 = drive_engine(ctx, "int8", cfg, params, sparse8, prompts,
                        ("espim_spmv_batched_quant",
                         "espim_spmv_batched_quant_glu"))
    eng_fp = drive_engine(ctx, "fp32", cfg_fp, params_fp, sparse_fp,
                          prompts[:4], ("espim_spmv_batched",
                                        "espim_spmv_batched_glu"))
    report["engine"] = {"int8": eng8, "fp32": eng_fp}
    launches_main = {
        "espim_spmv_batched": eng_fp["launches"]["espim_spmv_batched"],
        "espim_spmv_batched_glu": eng_fp["launches"]["espim_spmv_batched_glu"],
        "espim_spmv_batched_quant":
            eng8["launches"]["espim_spmv_batched_quant"],
        "espim_spmv_batched_quant_glu":
            eng8["launches"]["espim_spmv_batched_quant_glu"]}

    report["parity"] = {
        "int8": decode_parity(ctx, "int8", cfg, params, sparse8),
        "fp32": decode_parity(ctx, "fp32", cfg_fp, params_fp, sparse_fp)}
    report["decode_step"] = decode_step_profile(
        ctx, "decode_step_sparse int8", cfg,
        sparse_step(ctx, cfg, params, sparse8))
    entries = phase_kernels(ctx, sparse8, sparse_fp, launches_main)
    proj = phase_projection(ctx, params)
    phase_dense(ctx, cfg, params, cfg_fp, params_fp, sparse8, prompts, eng8)
    groups = new_kernel_cases(ctx, proj, sparse_fp)
    launches_main["espim_spmv"] = proj["launches"]["espim_spmv"]
    launches_main.update({k: v for k, v in phase_ops(ctx, groups).items()
                          if k in ("espim_spmv_batched_res", "dense_mv",
                                   "flash_attention")})
    return entries + phase_new_kernels(ctx, groups, launches_main)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"FAIL: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # float32 products in full float32, as the plain versions assume
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    report = {"card": card, "device": name, "seed": args.seed,
              "torch": torch.__version__, "cuda": torch.version.cuda}
    ctx = {"torch": torch, "device": dev, "seed": args.seed, "impl": None,
           "report": report, "timer": Timer(torch),
           "bandwidth": card_bandwidth(name)}
    log(f"[card] {name} ({card}); torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; data-sheet bandwidth "
        f"{ctx['bandwidth'] / 1e12:.2f} TB/s")
    try:
        phase_build(report)
        entries = run(ctx)
    except Exception:
        traceback.print_exc()
        print("FAIL: chip smoke run failed", file=sys.stderr)
        return 1
    report["kernels"] = entries
    report["seconds"] = time.perf_counter() - t_start
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                    default=str))
    log(f"[done] {report['seconds']:.1f} s; details in "
        f"{out / 'chip_smoke.json'}")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
