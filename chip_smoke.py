#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out DIR]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
library per source, one nvcc each, all started together) and drives the
port's paths at the full width of ``llama7b-espim`` (random weights from
``--seed``): int8 ESPIM decode through ``ServeEngine`` (depth cut to 2
layers), the standalone projection layers, the dense serving mode and the
fault ladder's dense rungs, the engine's fault, crash and overload
drills, the ops of the other kernels, the other model families at their
own published widths, and training (granite-3-2b at its published
widths and depth) — then checks them:

1. build: nvcc the kernels (five libraries: espim_spmv, dense_mv,
   flash_attention, wkv and decode_attention), print the build time and ptxas' report, and
   the tensor-core instructions in the flash library's SASS (HGMMA for
   wgmma, HMMA for mma.sync); fails if its bf16 (wgmma) body holds no
   HGMMA or its fp32 (3xTF32) body no HMMA, or if any instance of the
   WKV kernels or of kernel 5's mv body spills (ptxas' spill bytes);
2. engine: 8 requests through the int8 engine (kernels 2 and 4), then 4
   through a 1-layer fp engine (kernels 1 and 3), each trace served 3
   times; every launch counter is zeroed just before each serve and read
   just after, and each kernel of the path must have launched, an SpMV
   kernel once a group a layer a decode step;
3. decode parity: 4 teacher-forced decode steps at B=4 through the kernels
   and through their plain versions, from the same packs and cache; one
   step with the GLU epilogue fused against unfused, in bits; then one
   decode step's host time, and from ``torch.profiler``'s device kernel
   spans the device-busy share, the SpMV share of device time and the
   SpMV kernels a step (one a group a layer);
4. SpMV kernels: the five kernels on the streaming body (1-4 and the
   residual kernel 6) against their plain versions at the engine packs'
   full-width bucket shapes (plus int4 planes, one QKV and one gate+up
   bucket with an odd Lc, and kernels 1, 3 and 6 on the fp32 packs'
   planes cast to bf16), B in {1, 2, 3, 4, 8, 13}, each launched twice
   for identical bits; every engine group as one grouped launch
   (``ops.espim_spmv_group``: fp32, bf16, int8, int4, and int4 with an
   odd Lc) under the same rules against the grouped plain version, and
   in bits against its buckets' launches followed by the scale,
   concatenation and take; then kernels 1-4 timed per layer at B in {1,
   4}, one grouped launch a group, beside the same buckets launched one
   at a time and the earlier streaming body's time, and each bucket
   launch of kernels 1-4 and 6 at B = 4 on its own (a
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
7. robustness: the fault drill over its eight kinds on the int8 packs
   (load faults rejected; no runtime kind fails a request or leaks a
   block; the guard, the retry and the watchdog trip; the abort cancels
   one request), the crash drill on the fp32 packs killed at its middle
   step, preemption on the int8 packs in an arena of the long request's
   worst case, the overload drill (``check_overload_drill``) and the
   8-request trace through replay prefill (kernels 2 and 4 rise by the
   ticks its prompt tokens take); every restored or preempted request
   completes with at least ``RESUME_EQUAL_MIN`` of its later tokens
   equal to the uninterrupted run's; each drill must launch its pack's
   kernels (counters zeroed before, read after).  Then kernels 1-4, per
   bucket and grouped, must give a column the same bits alone as inside
   B = 4,
   and ``python -m repro_torch.launch.serve`` at llama7b-espim's full
   depth and width as a subprocess (4 requests, 32 tokens);
8. ops: the residual epilogue over the fp32 engine's attn_out and down
   buckets, ``ops.dense_mv`` and ``flash_attention`` at the shapes of
   step 9, counters zeroed before and read after;
9. decode attention (``kernels/decode_attention``: RoPE, the cache
   write and the attention in one launch a layer, which the int8 engine
   of step 2 must have launched once a layer a decode step) against its
   plain version at B 32 x S 1536, bf16, GQA 32/8 and 8/8, hd 64 and
   128, every row live, a chat mix of lengths and the edges, and at B 1:
   the caches in the plain version's bits, the output within 2^-7 of
   each element + 2^-10 of the largest, the same bits twice; timed
   beside the plain version, ``scaled_dot_product_attention`` (a
   yardstick) and the bound; then kernels 5-8 against their plain
   versions, each launched twice for
   identical bits: the unbatched kernel on the projection packs in fp32
   and bf16 (after the timings also ``mv_checks``: both mixed dtypes, an
   Lc of 13 in every dtype pair, 64 rows, x of 65536 f32 columns, R 0,
   and rows 1001:1065 launched alone in the whole launch's bits); the
   residual kernel per call at B in {1, 4} (and on bf16
   planes at B = 4); dense MV at (4096, 4096), (4096, 11008) and
   (11008, 4096) in fp32 and bf16; flash attention at BH = 32, hd = 128,
   S in {77, 512, 2048}, and at hd 32, 64 and 80 (zero-padded to 128)
   with a ragged S = 200, causal or not, fp32 and bf16 (bf16 also within
   a bound on the relative L2 error of the whole output) — each with its
   time, the plain version's, a library call of the same function that
   the port never makes (each timed by CUDA events around replays of a
   captured CUDA graph), and the least time the card could take; after
   the families phase, the WKV kernels at rwkv6-1.6b's full width (32
   heads of 64) against ``wkv6_ref`` / ``wkv6_bwd_ref``: the forward at
   B 1 x S 512 (the prefill, bf16 and fp32 r / k / v), B 1 x S 16 (the
   engine's chunk) and B 4 x S 1 (decode; also at a sharded decode's K'
   4, 8, 16 (bf16) and 32 (fp32)) in bf16, the backward at B 8 x S 128
   in fp32 and bf16, each launched twice for identical bits (the
   prefill and chunk forwards also as two launches over S / 2 carrying
   the state, in the bits of one), timed (20 launches a graph, and one)
   beside the plain version, the bound, its share and the serial floor
   (no library call computes the recurrence); then every forward
   instance (bf16 and fp32 x 1-16 k-groups) at B 2 x S 48 against the
   plain version, checkpoints included;
10. families: each other family's assigned arch at its published widths
   and vocab, bf16 params from ``init_params`` with the float32 leaves
   kept (phi3.5-moe at 2 of 32 layers, zamba2 at 12 of 54, qwen2-vl-2b,
   whisper-small and rwkv6-1.6b whole): (a) ``prefill_fn`` (kernel 8 in
   every forward and in Whisper's encoder; its counter zeroed before
   and read after, and it must read one launch per equal-length
   attention; rwkv6's one WKV launch a layer instead) against
   teacher-forced decode in fp32, within 5e-5 of
   max|forward| (MoE with a capacity factor that drops nothing; Whisper
   primed from seeded frames; rwkv6 at 4 layers, its whole depth
   reported beside a float64 control); (b) decode at depth 1 (zamba2:
   6) on the card against the CPU in fp32; (c) rwkv6 and zamba2 through
   the serving prefiller's chunks against token replay; (d) kernel 8 at
   the slice's shapes (Whisper's encoder at S = 1500, hd 64, full; the
   GQA forwards of phi3.5 and qwen2-vl and zamba2's hd 80, causal, S =
   512) against its plain version, fp32 and bf16, timed beside SDPA and
   the bound; (e) ``ServeEngine(sparse=None)`` on the 8-request trace,
   replay or chunked prefill as the family has it, and one decode
   step's profile (rwkv6: one WKV launch a layer a prefill chunk and a
   decode step, its TTFT beside the per-token loop's); (f) the launcher
   for each family (phi3.5 at 2 layers), all five as subprocesses at
   once;
11. autotune, after every counter read (a launch inside a captured timing
   graph counts once, at capture): no ``ESPIM_IMPL`` pin but ``cuda`` and
   ``ops.provenance()`` naming backend ``cuda``; layer 0's w_gate (11008 x
   4096 at 90% sparsity) under every legal schedule of kernels 1-2 (chunk
   width x warps a row x U; fp32, bf16, int8, int4 planes; B in {1, 4}):
   integer-valued planes and x give the default schedule's and the plain
   version's bits, real values stay within the kernels' tolerance; the
   explicit default schedule gives ``schedule=None``'s bits on every case
   of step 4; ``autotune_pack`` (fp32, int8; B in {1, 4}) searches, prints
   the winner's and the default's µs by ``time_launch`` and by ``Timer``,
   and a second call is a cache hit with 0 benchmarks; every bucket of one
   int8 engine layer at B = 4 timed over its schedules, default against
   best; ``pack_to_device(autotune=True)`` attaches the plan and
   ``espim_matvec`` matches ``impl="ref"``; and
   ``examples/serve_sparse_llm_torch.py --autotune`` as a subprocess.

12. train, after llama7b's params and packs are freed, on one process and
   a (1, 1) NCCL mesh (``launch.mesh.make_local_mesh``): (g) first,
   ``layers.flash_attention`` at phi3.5's attention shape in bf16 launches
   kernel 8 under no_grad and not under grad, whose q/k/v gradients equal
   the chunked softmax's bits; (a) ``Trainer`` on granite-3-2b at its whole
   40 layers and published widths (bf16 params, float32 master, remat
   "full"), 4 steps of B 8 x S 128, no checkpoint: finite loss and grad
   norm, kernel 8 never launched; the step's ms (median of steps 2-4),
   tokens/s, peak GB and share of the bf16 peak (8 N tokens + attention
   FLOPs); (b) one ``train_step_fn`` at 2 of 40 layers, float32, B 2 x S
   32, on the card against the CPU from the same seed: the loss, the grad
   norm and every state leaf within ``TRAIN_REL_TOL`` of its max; (d)
   microbatches 2 against 1 within the same bound, and 3 compressed-grad
   steps with a finite loss; (e) ``make_train_step`` on the mesh against
   ``train_step_fn`` in bits, ``espim_matvec_sharded`` (kernel 5 once)
   against ``ESPIMLinear`` on layer 0's w_down, ``make_serve_step``
   against ``decode_step`` in bits; and the same for phi3.5-moe (1 of 32
   layers), qwen2-vl-2b (whole), zamba2-2.7b (12 of 54 layers),
   whisper-small (whole) and rwkv6-1.6b (4 layers) at their published
   widths in float32 on each family's sharded path, with the sharded
   prefill forward against ``forward`` in bits at S 512 and kernel 8
   launched as often in both (once a layer; zamba2 once an application
   of its shared block, whisper once an encoder and a decoder layer,
   rwkv6 never; rwkv6's WKV forward once a layer a forward, its
   recompute included, and its backward once a layer a step, as often
   on the mesh as in ``train_step_fn``); (c) at 2 layers in bf16, train 3,
   save, restore, train 2 against 5 straight, every state leaf and the
   last loss in bits (deterministic algorithms on; the checkpoint in a
   temp dir, removed); (f) ``python -m repro_torch.launch.train --arch
   granite-3-2b --reduced`` for 10 steps, then 12, which resumes at 10.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Exits non-zero, with no result,
when there is no CUDA device, when the port's sources are missing, or when
any check fails.  Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
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
# decode attention: (label, B, H, KV, hd, lengths) at S DECODE_ATTN_S; the
# first two are the served cells' shapes (granite-3-2b, 32 slots)
DECODE_ATTN_CASES = (("full", 32, 32, 8, 64, "full"),
                     ("chat", 32, 32, 8, 64, "chat"),
                     ("mix", 32, 32, 8, 64, "mix"),
                     ("mha", 32, 8, 8, 64, "mix"),
                     ("hd128", 32, 32, 8, 128, "full"),
                     ("b1", 1, 32, 8, 64, "full"))
DECODE_ATTN_S = 1536
DECODE_ATTN_REL, DECODE_ATTN_ABS = 2.0 ** -7, 2.0 ** -10
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
# the earlier streaming body (one launch a bucket), one layer's
# launches of kernels 1-4 (NVIDIA H100 80GB HBM3, 700 W; PERF.md's
# kernel table): printed beside the grouped ring body's
SPMV_STREAM_US = {("espim_spmv_batched", "fp32", 4): 89.4,
                ("espim_spmv_batched_quant", "int8", 4): 85.7,
                ("espim_spmv_batched_glu", "fp32", 4): 67.1,
                ("espim_spmv_batched_quant_glu", "int8", 4): 49.6}
STREAM_KERNELS = ("espim_spmv_batched", "espim_spmv_batched_quant",
                  "espim_spmv_batched_glu", "espim_spmv_batched_quant_glu",
                  "espim_spmv_batched_res")
CHECK_BATCHES = (1, 2, 3, 4, 8, 13)
TOP_KERNELS = 8                 # a step profile lists the kernels taking most
TIME_BATCHES = (1, 4)
# the SpMV kernels' names in a profiler trace: espim_spmv.cu's mv body
# (kernel 5) and the ring body's two kernels
SPMV_KERNEL_NAMES = ("espim_spmv_mv_kernel", "espim_spmv_stream_kernel",
                     "espim_spmv_stream_glu_kernel")
# bf16 inputs and attention: the JAX package's own test tolerances, as
# |kernel - plain| <= atol + rtol * |plain| elementwise
# (tests/test_kernels.py:84, tests/test_flash_kernel.py:32,43).  Kernel 5
# has no entry: its plain version widens bf16 values and x exactly and
# sums in fp32, as the kernel does, so every dtype pair is held to the
# fp32 rule (KERNEL_REL_TOL * max|plain| + KERNEL_ABS_TOL)
ALLCLOSE_TOL = {"dense_mv/bf16": 5e-2,
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
# the robustness phase: a restored or preempted request re-prefills its
# history through the GEMMs where the uninterrupted run wrote it through
# the SpMV kernels, so its later tokens are held to a share equal to the
# uninterrupted run's, not to every token
RESUME_EQUAL_MIN = 0.9
INT8_KERNELS = ("espim_spmv_batched_quant", "espim_spmv_batched_quant_glu")
FP_KERNELS = ("espim_spmv_batched", "espim_spmv_batched_glu")
# the launcher at llama7b-espim's full depth and width (dense, bf16)
LAUNCHER_ARGS = ("--arch", ARCH, "--requests", "4", "--max-new-tokens", "8")
LAUNCHER_TIMEOUT_S = 600
AUTOTUNE_BATCHES = (1, 4)               # the autotune phase's B
AUTOTUNE_CANDIDATES = 12                # candidates a search times
EXAMPLE = ROOT / "examples" / "serve_sparse_llm_torch.py"
EXAMPLE_ARGS: tuple = ()
EXAMPLE_TIMEOUT_S = 600
# the families phase: each family's assigned arch at its published widths
# and vocab, bf16 params with the float32 leaves kept, depth cut where
# the weights or the phase's time force it: (arch, depth of the phase's
# model or None for whole, depth of the card-vs-CPU check, depth of the
# fp32 decode-vs-forward and chunked-vs-replay checks or None for the
# phase's).  rwkv6 with random weights amplifies a rounding difference
# ~1.5x a layer, and its WKV recurrence stays float32 at any model dtype
# (as the reference's), so at 24 layers forward and decode differ by
# ~1e-2 of max|logits| even with every other op in float64 (reported by
# the phase); its fp32 checks run at 4 layers
FAMILIES = (("phi3.5-moe-42b-a6.6b", 2, 1, None),
            ("qwen2-vl-2b", None, 1, None),
            ("whisper-small", None, 1, None),
            ("rwkv6-1.6b", None, 1, 4),
            ("zamba2-2.7b", 12, 6, None))
FAMILY_B, FAMILY_S = 2, 8               # teacher-forced tokens of (a)
FAMILY_CPU_STEPS = 4                    # decode steps of (b)
# (a) and (c): the JAX package's decode-vs-forward bound,
# max|got - want| / max|want| (tests/test_models_smoke.py:64)
FAMILY_REL_TOL = 5e-5
FAMILY_PROMPT = 21                      # (c): two chunks of 16, one padded
FAMILY_CHUNK = 16
FAMILY_ENGINE_RUNS = 1                  # measured serves a family
FAMILY_FLASH_SEQ = 512                  # (d): the forwards' S
# (f): the launcher per family; phi3.5-moe's 32 layers (84 GB in bf16)
# do not fit the card, so it serves 2
FAMILY_LAUNCHER_LAYERS = {"phi3.5-moe-42b-a6.6b": 2}
FAMILY_LAUNCHER_ARGS = ("--requests", "4", "--max-new-tokens", "8")
# the WKV kernels at rwkv6-1.6b's full width: (label, B, S, r / k / v
# dtype, backward, K'); the forward at the prefill's (bf16, and fp32 as
# the fp32 forwards of the families and train phases run it), the
# engine's chunk's and decode's shapes, and at a sharded decode's K
# slice (K' 4: hd 64 over 16 model ranks), the backward at the train
# step's (fp32 as check (e) runs it, bf16 as the dryrun phase's card
# step does); decode also at the K' 8, 16 and 32 slices (8, 4 and 2 model
# ranks), the plan's 2, 4 and 8 k-groups
WKV_HEADS, WKV_HD = 32, 64
WKV_CASES = (("prefill", 1, 512, "bf16", False, WKV_HD),
             ("prefill32", 1, 512, "fp32", False, WKV_HD),
             ("chunk", 1, FAMILY_CHUNK, "bf16", False, WKV_HD),
             ("decode", 4, 1, "bf16", False, WKV_HD),
             ("decode_k4", 4, 1, "bf16", False, 4),
             ("decode_k8", 4, 1, "bf16", False, 8),
             ("decode_k16", 4, 1, "bf16", False, 16),
             ("decode_k32", 4, 1, "fp32", False, 32),
             ("train", 8, 128, "fp32", True, WKV_HD),
             ("train16", 8, 128, "bf16", True, WKV_HD))
WKV_MAIN = {"wkv6": "prefill", "wkv6_bwd": "train"}   # the kernels line
# the forward cases also run as two launches over S/2 carrying the state
WKV_SPLIT_CASES = ("prefill", "chunk")
# launches a timed graph holds (``Timer``'s per_graph): a decode step's
# launch is shorter than a replay's host cost
WKV_PER_GRAPH = 20
# the fewest float32 operations a (b, t, h, k, j) the function needs (an
# fma counts 2; terms of O(K' + V) a (b, t, h) left out).  Forward 5:
# y_t = S^T r_t + (sum_k r u k) v_t is one fma a (k, j), the state
# w S + k v a multiply and an fma.  Backward 14: the chunk's states
# recomputed from the checkpoints (3), dr = S gy (2), dk = dS v (2),
# dw = sum_j dS S (2), dv = dS^T k + (sum_k u r k) gy (2), and
# dS = r gy^T + w dS (3)
WKV_FWD_OPS, WKV_BWD_OPS = 5, 14
# the forward's instances (bf16, fp32 x 1, 2, 4, 8, 16 k-groups) and the
# backward's (bf16, fp32): the build phase holds each to no spill
WKV_INSTANCES = 12
# kernel 5's mv body: f32 and bf16 planes x f32 and bf16 x x (the vector
# walk with x staged, or either walk with x anywhere); the build phase
# holds each to no spill
MV_INSTANCES = 8
# kernel 5's cases beyond the timed ones (``mv_checks``): a pack of fewer
# rows than the SMs, an x too wide for shared memory (its rows, 128
# chunks of 48 slots, longer than a stage: they go in pieces), an Lc that
# is not a multiple of 4 (the down pack's first 13 slots a chunk), and
# the rows launched alone against the same rows of the whole launch (an
# odd first row: the odd-Lc pack's spans start off 16 bytes)
MV_FEW_ROWS = 64
MV_WIDE = (256, 65536, 48)      # rows, f32 columns, Lc
MV_ODD_LC = 13
MV_SLICE = (1001, 1065)
# every forward instance against the plain version (``wkv_instances``),
# at B 2 x S 48 (three tiles, a checkpoint after 32 steps): bf16 at K' 4
# KG, fp32 at odd K' (rows padded with zeros, the copies not 16-byte
# aligned)
WKV_SWEEP = (tuple(("bf16", 4 * g) for g in (1, 2, 4, 8, 16))
             + tuple(("fp32", kp) for kp in (3, 7, 13, 27, 63)))
WKV_SWEEP_BS = (2, 48)
# a step's serial floor: the state's fma chain, one dependent fma (4
# cycles) a step at the H100 SXM's 1.98 GHz boost clock (data sheet)
WKV_STEP_FLOOR_S = 4 / 1.98e9
# rwkv6's TTFT p50 through the per-token WKV loop (a run of this script
# before the WKV op, NVIDIA H100 80GB HBM3, 700 W): printed beside this
# run's
LOOP_RWKV6_TTFT_MS = 628.6
# the train phase: granite-3-2b, the reference launcher's and training
# test's model (src/repro/launch/train.py:1-2), at its published widths
TRAIN_ARCH = "granite-3-2b"
TRAIN_SEQ, TRAIN_BATCH = 128, 8         # (a) and (c): the launcher's shape
TRAIN_STEPS = 4                         # (a): steps 2-4 are timed
TRAIN_CHECK_LAYERS = 2                  # (b)-(e): 2 of 40 layers
TRAIN_CHECK_SEQ, TRAIN_CHECK_BATCH = 32, 2
# (b), (d): float32 on the card against the CPU, max|diff| / max|CPU| per
# state leaf, and for the loss and the grad norm: cuBLAS and the CPU sum
# each product in another order (~1e-6 relative at K <= 8192, as the
# families' card-vs-CPU read 0.9e-6 to 3.1e-6), and step 1 of AdamW moves
# a param by lr (3e-6 at step 1 of the default schedule) times a
# direction g / (|g| + eps), whose error stays below 0.1 even where
# |g| ~ eps: 3e-7, ~3e-6 of a leaf's max
TRAIN_REL_TOL = 1e-5
TRAIN_COMPRESS_STEPS = 3                # (d): steps with compress_grads
TRAIN_LAUNCHER_ARGS = ("--arch", TRAIN_ARCH, "--reduced")
TRAIN_LAUNCHER_STEPS = (10, 12)         # (f): fresh, then resumed
TRAIN_MATVEC_SPARSITY = 0.9             # (e): layer 0's w_down, pruned
# (g): phi3.5-moe's attention (GQA 32/8, hd 128) at the families' S
TRAIN_FLASH_SHAPE = (1, FAMILY_FLASH_SEQ, 32, 8, 128)
# (e) for the other families' sharded paths: (arch, depth or None for
# whole) at the published widths in float32, the depth at which two
# copies of the float32 train state (params, mu, nu) fit the card beside
# the step's grads: phi3.5-moe's 1 of 32 layers is 1.56 B params (18.8
# GB a copy; 2 layers would be 34 GB a copy), qwen2-vl-2b whole 1.54 B
# (18.5 GB a copy); zamba2 at 12 of 54 layers (0.6 B params) as the
# dryrun phase's (b) cuts it, rwkv6 at 4 (0.35 B), whisper-small whole
# (0.24 B)
TRAIN_FAMILY_MESH = (("phi3.5-moe-42b-a6.6b", 1), ("qwen2-vl-2b", None),
                     ("zamba2-2.7b", 12), ("whisper-small", None),
                     ("rwkv6-1.6b", 4))

# the dryrun phase: the dry run's predictions of one train step at (a)'s
# shape (B 8 x S 128) on a one-rank fake group, each traced in a worker
# process of its own (a fake group must be its process's default group),
# against the card: (a) granite-3-2b whole; (b) each other family at a
# depth that fits the card (phi3.5-moe's 2 layers, as the families
# phase's; zamba2 at 12 of 54 for time; rwkv6 whole, its WKV one op a
# layer); (c) granite at 4 layers under each remat policy
DRYRUN_FAMILIES = (("phi3.5-moe-42b-a6.6b", 2), ("qwen2-vl-2b", None),
                   ("whisper-small", None), ("rwkv6-1.6b", None),
                   ("zamba2-2.7b", 12))
DRYRUN_REMATS = ("none", "dots", "full")
DRYRUN_REMAT_LAYERS = 4
DRYRUN_STEPS = 2                        # (b), (c): the second is timed
# (a): the predicted peak within 15% of the train phase's measured peak,
# the predicted dot FLOPs within 2% of the products the card's step runs
# (``torch.utils.flop_counter.FlopCounterMode`` around a real step).  The
# train phase's 8 N tokens + attention counts 7.6% more: remat's
# recompute stops early (the w_down product, the last of a layer, is not
# needed for the backward) and the tied lm_head sits outside the
# checkpointed layers, 2 (L D F + V D) tokens fewer
DRYRUN_PEAK_TOL, DRYRUN_FLOP_TOL = 0.15, 0.02
# (d): the dry run's launcher on production cells (fake 256-rank groups),
# the sharded steps: the train step (ZeRO-3 on data, TP on model, for
# phi3.5-moe the experts on model) and the decode step (tensor-parallel
# products over (data, model), a MoE layer's experts on model and their
# F on data, the int8 cache sequence-sharded; zamba2's SSM state and
# whisper's K / V caches at their shards); rwkv6's train_4k (the WKV ops'
# forward and backward on fake cuda tensors under grad); granite's,
# zamba2's, whisper's and rwkv6's must fit the card, phi3.5-moe's print
# their peak and fits_card
DRYRUN_ARCHS = (TRAIN_ARCH, "phi3.5-moe-42b-a6.6b")
DRYRUN_DECODE_ARCHS = ("zamba2-2.7b", "whisper-small")
DRYRUN_TRAIN_ARCHS = ("rwkv6-1.6b",)
DRYRUN_FIT = (TRAIN_ARCH,) + DRYRUN_DECODE_ARCHS + DRYRUN_TRAIN_ARCHS
DRYRUN_CLIS = {
    f"cli_{arch}_{shape}": ("-m", "repro_torch.launch.dryrun", "--arch",
                            arch, "--shape", shape, "--mesh", "single",
                            "--force")
    for arch, shape in [(a, s) for a in DRYRUN_ARCHS
                        for s in ("train_4k", "decode_32k")]
    + [(a, "decode_32k") for a in DRYRUN_DECODE_ARCHS]
    + [(a, "train_4k") for a in DRYRUN_TRAIN_ARCHS]}
# (d)'s decode_32k cells, per device, when the decode step gathered every
# layer's weights (the dry run of the tree before the tensor-parallel
# products, CPU; for zamba2 and whisper the tree before their sharded
# steps): dot FLOPs, dot bytes, collective operand bytes and calls by
# kind; printed beside this run's.  The new step all-gathers
# activations only: at most DRYRUN_DECODE_GATHER_SHARE of the old bytes
GATHERED_DECODE = {
    TRAIN_ARCH: {"dot_flops": 4.591e10, "dot_bytes": 10.30e9,
                 "all-gather": (0.334e9, 403), "all-reduce": (2.703e6, 120),
                 "reduce-scatter": (0.0, 0)},
    "phi3.5-moe-42b-a6.6b": {"dot_flops": 1.330e11, "dot_bytes": 20.02e9,
                             "all-gather": (0.518e9, 261),
                             "all-reduce": (6.359e6, 192),
                             "reduce-scatter": (0.0, 0)},
    # the two families that gathered their params, cache and batch whole
    # on every rank
    "zamba2-2.7b": {"dot_flops": 1.205e12, "dot_bytes": 814.6e9,
                    "all-gather": (26.58e9, 21), "all-reduce": (0.0, 0),
                    "reduce-scatter": (0.0, 0)},
    "whisper-small": {"dot_flops": 1.973e11, "dot_bytes": 332.4e9,
                      "all-gather": (10.74e9, 31), "all-reduce": (0.0, 0),
                      "reduce-scatter": (0.0, 0)}}
DRYRUN_DECODE_GATHER_SHARE = 0.05
# the train phase's step (a) in two whole runs of this script before the
# dense family's sharded path (NVIDIA H100 80GB HBM3, 700 W): printed
# beside this run's
GATHERED_TRAIN_STEP_MS = (623.7, 772.6)
DRYRUN_TIMEOUT_S = 900

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
    # jnp of the reference, not a pallas_call
    "decode_attention": ("src/repro/models/transformer.py",
                         "attn_decode_core",
                         "src/repro_torch/kernels/csrc/decode_attention.cu"),
    # a compiled loop of the reference, not a pallas_call
    "wkv6": ("src/repro/models/rwkv.py:116", "jax.lax.scan",
             "src/repro_torch/kernels/csrc/wkv.cu"),
    "wkv6_bwd": ("src/repro/models/rwkv.py:116", "jax.lax.scan",
                 "src/repro_torch/kernels/csrc/wkv.cu"),
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


def ptxas_spills(report: str) -> dict:
    """{function: (spill store bytes, spill load bytes)} from ``nvcc
    -Xptxas -v``'s report."""
    out, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn] = (int(m.group(1)), int(m.group(2)))
            fn = None
    return out


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
    kernels, is as slow as the kernels).  ``per_graph`` > 1 captures
    ``fn`` that many times into the graph and divides: a replay costs the
    host ~10 us, so a call shorter than that is timed only this way."""

    def __init__(self, torch):
        self.torch = torch

    def __call__(self, fn, reps: int = 10, trials: int = 5,
                 per_graph: int = 1) -> float:
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
            for _ in range(per_graph):
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
            out.append(a.elapsed_time(b) / reps / per_graph)
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
    spills = ptxas_spills(build.BUILD_LOG["wkv"]["log"])
    report["build"]["wkv_spills"] = spills
    wkv_fns = {fn: n for fn, n in spills.items()
               if "wkv6_fwd_kernel" in fn or "wkv6_bwd_kernel" in fn}
    log(f"[build] wkv spill bytes (stores, loads) by instance: "
        f"{sorted(set(wkv_fns.values()))} over {len(wkv_fns)} instances")
    need(len(wkv_fns) == WKV_INSTANCES,
         f"[build] ptxas reported {len(wkv_fns)} WKV kernel instances, want "
         f"{WKV_INSTANCES}")
    need(all(n == (0, 0) for n in wkv_fns.values()),
         f"[build] a WKV kernel instance spills: "
         f"{ {fn: n for fn, n in wkv_fns.items() if n != (0, 0)} }")
    spills = ptxas_spills(build.BUILD_LOG["espim_spmv"]["log"])
    mv_fns = {fn: n for fn, n in spills.items()
              if "espim_spmv_mv_kernel" in fn}
    report["build"]["mv_spills"] = mv_fns
    log(f"[build] kernel 5 (mv body) spill bytes (stores, loads) by "
        f"instance: {sorted(set(mv_fns.values()))} over {len(mv_fns)} "
        f"instances")
    need(len(mv_fns) == MV_INSTANCES,
         f"[build] ptxas reported {len(mv_fns)} kernel-5 instances, want "
         f"{MV_INSTANCES}")
    need(all(n == (0, 0) for n in mv_fns.values()),
         f"[build] a kernel-5 instance spills: "
         f"{ {fn: n for fn, n in mv_fns.items() if n != (0, 0)} }")
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
    from repro_torch.kernels import dense_mv, espim_spmv, flash_attention, wkv
    return espim_spmv, dense_mv, flash_attention, wkv


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


def group_launches(cfg, sparse) -> dict:
    """The SpMV launches one sparse decode step makes: one a group a
    layer, as the kernel it computes (kernels 1-4)."""
    out = {}
    for gname, g in sparse["groups"].items():
        k = ("espim_spmv_batched_quant" if g["quant"] is not None
             else "espim_spmv_batched")
        k += "_glu" if gname == "gateup" and sparse["gated"] else ""
        out[k] = out.get(k, 0) + cfg.n_layers
    return out


def drive_engine(ctx, label, cfg, params, sparse, prompts, kernels,
                 runs: int = None) -> dict:
    """Warm up, then ``runs`` (``ENGINE_RUNS``) times: zero the launch
    counters, serve
    ``prompts``, read the counters; every kernel in ``kernels`` must have
    launched in every run, and a dense engine (``sparse=None``) must have
    launched no other; a sparse engine's SpMV kernels, once a group a
    layer a decode step (``group_launches``; prefill runs the dense
    copies).  Reports each run's tok/s, TTFT and TPOT p50, their
    medians, and the last run's launch counts and outputs."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.serve import engine as E
    from repro_torch.serve.scheduler import latency_summary
    torch = ctx["torch"]
    eng = E.ServeEngine(cfg, params, sparse=sparse, device=ctx["device"],
                        **ENGINE_KW)
    serve(E, eng, [prompts[0][:3]], 2)                 # warm-up request
    n_runs = runs or ENGINE_RUNS
    runs = []
    for _ in range(n_runs):
        eng.reset_stats()
        reset_launches()
        DA.reset_launches()
        reqs, stats, wall = serve(E, eng, prompts, MAX_NEW)
        launches = read_launches()
        attn = DA.LAUNCHES["decode_attention"]
        need(attn in (0, DA.KERNELS_A_CALL * cfg.n_layers
                      * stats.decode_steps),
             f"[{label}] decode attention: {attn} kernel launches in "
             f"{stats.decode_steps} decode steps, neither none nor one call "
             f"({DA.KERNELS_A_CALL} kernels) a layer a step")
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
            other = {k: v for k, v in launches.items()
                     if v and k not in kernels}
            need(not other,
                 f"[{label}] the dense engine launched kernels {other}")
        else:
            for k, n in group_launches(cfg, sparse).items():
                need(launches[k] == n * stats.decode_steps,
                     f"[{label}] kernel {k}: {launches[k]} launches in "
                     f"{stats.decode_steps} decode steps, not {n} a step "
                     "(one a group a layer)")
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
           "decode_attention_launches": attn,
           # kernel launches a layer a decode step: KERNELS_A_CALL where
           # the step takes the decode attention kernel, else 0
           "decode_attention_per_layer_step":
               attn / max(1, cfg.n_layers * stats.decode_steps),
           "launches_per_decode_step": {
               k: v / max(1, stats.decode_steps) for k, v in launches.items()},
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}

    def spread(key, scale, fmt):
        return "/".join(format(r[key] * scale, fmt) for r in runs)

    log(f"[engine:{label}] {len(prompts)} requests, "
        f"{stats.tokens_generated} tokens per run, {n_runs} runs: "
        f"{spread('tok_per_s', 1, '.1f')} tok/s; TTFT p50 "
        f"{spread('ttft_p50_s', 1e3, '.1f')} ms; TPOT p50 "
        f"{spread('tpot_p50_s', 1e3, '.2f')} ms; {stats.decode_steps} decode "
        f"steps, {stats.prefill_chunks} prefill chunks")
    log(f"[engine:{label}] launches {launches}; per decode step "
        + ", ".join(f"{k} {v:g}" for k, v in
                    rec["launches_per_decode_step"].items() if v)
        + f"; decode attention {attn} kernel launches, "
        f"{rec['decode_attention_per_layer_step']:g} a layer a step")
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


def device_profile(torch, fn, reps: int) -> dict:
    """``reps`` calls of ``fn`` under ``torch.profiler``: the host-clock
    ms of the window (synchronised), the µs the device was busy (the
    union of device kernel spans: a CPU op's device time repeats its
    kernels'), the kernel count, {name: (count, µs)}, and the
    ``TOP_KERNELS`` names taking most per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        name = e.name[:60]
        cnt, tot = by_name.get(name, (0, 0.0))
        by_name[name] = (cnt + 1, tot + e.time_range.elapsed_us())
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    top = [{"name": n, "per_step": c / reps, "us_per_step": t / reps}
           for n, (c, t) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1])[:TOP_KERNELS]]
    return {"wall_ms": wall_ms, "busy_us": busy_us, "kernels": len(spans),
            "by_name": by_name, "top": top}


def decode_step_profile(ctx, label, cfg, step_fn, b=4, reps=10) -> dict:
    """Where a decode step's time goes: host-clock time of one
    ``step_fn(cache, batch)`` call (synchronised), and, from
    ``torch.profiler`` over ``reps`` steps, the device-busy share, the
    device kernels per step, the SpMV kernels' share of device time and
    the device µs per step of the kernels that take the most."""
    from repro_torch.models.factory import init_cache
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
    prof = device_profile(torch, step, reps)
    if prof["busy_us"] > 0:     # else the profiler saw no device time
        spmv = [(c, t) for n, (c, t) in prof["by_name"].items()
                if any(k in n for k in SPMV_KERNEL_NAMES)]
        spmv_us = sum(t for _, t in spmv)
        rec.update(device_ms_per_step=prof["busy_us"] / 1e3 / reps,
                   device_busy_share=prof["busy_us"] / 1e3 / prof["wall_ms"],
                   spmv_share_of_device=spmv_us / prof["busy_us"],
                   spmv_us_per_step=spmv_us / reps,
                   spmv_kernels_per_step=sum(c for c, _ in spmv) / reps,
                   kernels_per_step=prof["kernels"] / reps,
                   top_kernels=prof["top"])
    log(f"[step] {label} B={b}, {cfg.n_layers} layers: "
        f"{rec['step_ms']:.2f} ms per step (host clock); device busy "
        f"{rec['device_busy_share']}, device ms/step "
        f"{rec['device_ms_per_step']}, SpMV share of device time "
        f"{rec['spmv_share_of_device']} ({rec.get('spmv_us_per_step')} us, "
        f"{rec.get('spmv_kernels_per_step')} SpMV kernels), kernels per step "
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


def run_case(ops, c, x, impl, schedule=None):
    kw = dict(chunk_cols=c["cc"], impl=impl, schedule=schedule)
    if c["kernel"] == "espim_spmv_batched":
        return ops.espim_spmv_batched(c["values"], c["cols"], x, **kw)
    if c["kernel"] == "espim_spmv_batched_res":
        return ops.espim_spmv_batched(c["values"], c["cols"], x,
                                      epilogue="residual",
                                      residual=c["res"][x.shape[1]], **kw)
    if c["kernel"] == "espim_spmv_batched_glu":
        return ops.espim_spmv_batched(c["values"], c["cols"], x,
                                      epilogue="glu", act="silu", **kw)
    if c["kernel"] == "espim_spmv_batched_quant":
        return ops.espim_spmv_batched_quant(c["q"], c["cols"], None, x, **kw)
    return ops.espim_spmv_batched_quant(c["q"], c["cols"], None, x,
                                        epilogue="glu", act="silu",
                                        srow=c["srow"], **kw)


def group_cases(ctx, sparse8, sparse_fp) -> list:
    """The grouped launches each kernel of 1-4 makes per layer, one a
    group: (kernel, variant, layer, group, the buckets' plane lists, srow,
    the take's perm and inv, act) over every engine group, fp32 and int8
    as the engines hold them, bf16 (the fp32 planes cast), int4 (the int8
    codes requantized to [-7, 7] and nibble-packed, as ``kernel_cases``
    makes them) and int4 with an odd Lc (layer 0's qkv and gate+up, every
    bucket's Lc cut by one); ``buckets`` holds the per-bucket cases
    (``kernel_cases``) of the same launches, for their bytes."""
    torch = ctx["torch"]
    per = {}
    for c in kernel_cases(ctx, sparse8, sparse_fp):
        if c["kernel"] != "espim_spmv_batched_res" and \
                c["variant"] != "int4-oddLc":
            key = (c["variant"], c["layer"], c["group"])
            per.setdefault(key, []).append(c)
    out = []
    for (variant, layer, gname), bks in per.items():
        src = sparse_fp if variant in ("fp32", "bf16") else sparse8
        g = src["groups"][gname]
        glu = gname == "gateup"
        quant = variant.startswith("int")
        take = g["output"] == "take"
        planes = [c["q" if quant else "values"] for c in bks]
        srow = ([b["srow"][layer] for b in sparse8["groups"][gname]["buckets"]]
                if quant else None)
        out.append(dict(
            kernel=bks[0]["kernel"], variant=variant, layer=layer,
            group=gname, values=planes, cols=[c["cols"] for c in bks],
            srow=srow, act="silu" if glu else None,
            perm=g["perm"][layer] if take else None,
            inv=g["inv_perm"][layer] if take else None,
            n_out=g["n_rows"] if take else None, cc=g["chunk_cols"],
            m=g["n_cols"], buckets=bks))
    # the odd-Lc int4 group: every bucket of layer 0's qkv and gate+up
    for gc in [gc for gc in out if gc["variant"] == "int4"
               and gc["layer"] == 0 and gc["group"] in ("qkv", "gateup")]:
        q8 = [b["q"][0] for b in sparse8["groups"][gc["group"]]["buckets"]]
        cols, vals = [], []
        for c, q in zip(gc["cols"], q8):
            lc = c.shape[-1] - (1 - c.shape[-1] % 2)     # odd
            q4 = torch.clamp(torch.round(q.float() / 18.0), -7, 7).to(
                torch.int8)
            cols.append(c[..., :lc].contiguous())
            vals.append(_nibble_pack(torch, q4[..., :lc]))
        out.append(dict(gc, variant="int4-oddLc", values=vals, cols=cols,
                        buckets=[dict(b, cols=c, q=v) for b, c, v in
                                 zip(gc["buckets"], cols, vals)]))
    return out


def run_group(ops, gc, x, impl, schedule=None):
    """One grouped launch (``ops.espim_spmv_group``) of a group case."""
    return ops.espim_spmv_group(gc["values"], gc["cols"], x,
                                chunk_cols=gc["cc"], srow=gc["srow"],
                                act=gc["act"], perm=gc["perm"],
                                n_out=gc["n_out"], impl=impl,
                                schedule=schedule)


def run_group_per_bucket(ops, gc, x, impl):
    """The same group as the decode step launched it before the grouped
    op: one launch a bucket, then each quantized bucket's srow multiply,
    the concatenation and the take."""
    parts = []
    for i, (v, c) in enumerate(zip(gc["values"], gc["cols"])):
        kw = dict(chunk_cols=gc["cc"], impl=impl)
        if gc["srow"] is not None and gc["act"]:
            parts.append(ops.espim_spmv_batched_quant(
                v, c, None, x, epilogue="glu", act=gc["act"],
                srow=gc["srow"][i], **kw))
        elif gc["srow"] is not None:
            parts.append(ops.espim_spmv_batched_quant(v, c, None, x, **kw)
                         * gc["srow"][i][:, None])
        elif gc["act"]:
            parts.append(ops.espim_spmv_batched(v, c, x, epilogue="glu",
                                                act=gc["act"], **kw))
        else:
            parts.append(ops.espim_spmv_batched(v, c, x, **kw))
    import torch
    y = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
    return y if gc["inv"] is None else y.index_select(0, gc["inv"])


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


def _check(what, got, want, again, torch) -> float:
    """max|kernel - plain|, after the kernels' rule: finite, the plain
    version's shape, within KERNEL_REL_TOL * max|plain| + KERNEL_ABS_TOL,
    and the same bits on a second launch."""
    err = float((got - want).abs().max()) if want.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    need(got.shape == want.shape and bool(torch.isfinite(got).all()),
         f"{what}: bad output")
    need(torch.equal(got, again), f"{what}: two launches on the "
         "same inputs gave different bits")
    need(err <= KERNEL_REL_TOL * scale + KERNEL_ABS_TOL,
         f"{what}: max|kernel-plain| {err:.3e} > "
         f"{KERNEL_REL_TOL}*{scale:.3e}+{KERNEL_ABS_TOL}")
    return err


def phase_kernels(ctx, sparse8, sparse_fp, launches_main) -> list:
    """Every kernel against its plain version (and against itself: two
    launches on the same inputs must give the same bits), per bucket and
    grouped (every engine group in one launch, also held in bits against
    its buckets' launches followed by the scale, concatenation and take),
    then timed.  The launches made here are comparisons: the line reports
    the engine runs' counts (``launches_main``)."""
    from repro_torch.kernels import ops
    torch, dev, timer = ctx["torch"], ctx["device"], ctx["timer"]
    bw = ctx["bandwidth"]
    cases = kernel_cases(ctx, sparse8, sparse_fp)
    gcases = group_cases(ctx, sparse8, sparse_fp)
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
            what = (f"{c['kernel']} {c['variant']} {c['group']}/"
                    f"b{c['bucket']} B={b}")
            err = _check(what, got, want, again, torch)
            worst[c["kernel"]] = max(worst[c["kernel"]], err)
            rows.append({"kernel": c["kernel"], "variant": c["variant"],
                         "layer": c["layer"], "group": c["group"],
                         "bucket": c["bucket"],
                         "shape": list(c["cols"].shape), "B": b,
                         "max_abs_err": err,
                         "max_abs_plain": float(want.abs().max())})
    n_bucket = len(rows)
    # the grouped launches: the same rule against the grouped plain
    # version, and the bits of the buckets' launches + scale, cat, take
    n_bits = 0
    for gc in gcases:
        for b in CHECK_BATCHES:
            x = xs[(gc["m"], b)]
            got = run_group(ops, gc, x, ctx["impl"])
            again = run_group(ops, gc, x, ctx["impl"])
            want = run_group(ops, gc, x, "ref")
            what = (f"{gc['kernel']} grouped {gc['variant']} "
                    f"layer {gc['layer']} {gc['group']} B={b}")
            err = _check(what, got, want, again, torch)
            unfused = run_group_per_bucket(ops, gc, x, ctx["impl"])
            need(torch.equal(got, unfused),
                 f"{what}: the grouped launch differs from its buckets' "
                 "launches + scale, concatenation and take by "
                 f"{float((got - unfused).abs().max()):.3e}")
            n_bits += 1
            worst[gc["kernel"]] = max(worst[gc["kernel"]], err)
            rows.append({"kernel": gc["kernel"], "variant": gc["variant"],
                         "layer": gc["layer"], "group": gc["group"],
                         "bucket": "grouped", "B": b,
                         "shape": [list(c.shape) for c in gc["cols"]],
                         "max_abs_err": err,
                         "max_abs_plain": float(want.abs().max())})
    log(f"[kernels] {n_bucket} per-bucket and {len(rows) - n_bucket} grouped "
        f"checks within {KERNEL_REL_TOL}*max|plain| + {KERNEL_ABS_TOL}, each "
        f"bit-identical across two launches; {n_bits} grouped launches "
        "bit-identical to their buckets' launches + scale, concatenation "
        "and take; worst max|kernel-plain| "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    ctx["worst"] = worst
    # 2) timing: per kernel and variant, one layer's launches at B in {1,4}
    # (one grouped launch a group, and beside it the same buckets launched
    # one at a time), cycling over every layer so the planes stream from
    # HBM (the packs of all layers exceed the 50 MB L2); kernel 6 is timed
    # per call, beside its addmm, by phase_new_kernels
    timed = {}
    for key in sorted({(gc["kernel"], gc["variant"]) for gc in gcases
                       if gc["variant"] != "int4-oddLc"}):
        sel = [gc for gc in gcases if (gc["kernel"], gc["variant"]) == key]
        n_layers = len({gc["layer"] for gc in sel})
        src = sparse_fp if key[1] in ("fp32", "bf16") else sparse8
        for b in TIME_BATCHES:
            def launch_all(impl, sel=sel, b=b):
                for gc in sel:
                    run_group(ops, gc, xs[(gc["m"], b)], impl)

            def launch_buckets(sel=sel, b=b):
                for gc in sel:
                    for c in gc["buckets"]:
                        run_case(ops, c, xs[(c["m"], b)], ctx["impl"])
            t_k = timer(lambda: launch_all(ctx["impl"])) / n_layers
            t_b = timer(launch_buckets) / n_layers
            t_p = timer(lambda: launch_all("ref"), reps=3) / n_layers
            bks = [c for gc in sel for c in gc["buckets"]]
            nbytes = sum(case_bytes(c, b)[0] for c in bks) / n_layers
            flops = sum(case_bytes(c, b)[1] for c in bks) / n_layers
            t_bytes, t_ops = nbytes / bw * 1e3, flops / PEAKS["fp32"] * 1e3
            # library: dense bf16 matmul of the same pruned (dequantized)
            # matrices, one call per group and layer
            mats = []
            for layer in range(n_layers):
                for gname in sorted({gc["group"] for gc in sel}):
                    g = src["groups"][gname]
                    xb = xs[(g["n_cols"], b)].T.to(torch.bfloat16).contiguous()
                    mats.append((xb, _dense_t(torch, src["pruned"],
                                              g["projections"], layer)))
            t_lib = timer(lambda: [torch.matmul(a, w) for a, w in mats]
                          ) / n_layers
            timed[(key, b)] = {
                "kernel": key[0], "variant": key[1], "B": b,
                "launches_per_layer": len(sel) // n_layers,
                "bucket_launches_per_layer": len(bks) // n_layers,
                "ms": t_k, "per_bucket_ms": t_b, "plain_ms": t_p,
                "library_ms": t_lib, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops,
                "achieved_GBps": nbytes / (t_k * 1e-3) / 1e9}
            r = timed[(key, b)]
            stream_us = SPMV_STREAM_US.get((key[0], key[1], b))
            log(f"[kernels] {key[0]:30s} {key[1]:5s} B={b}: "
                f"{r['launches_per_layer']} grouped launches/layer "
                f"{t_k * 1e3:8.1f} us (its {r['bucket_launches_per_layer']} "
                f"buckets one launch each {t_b * 1e3:8.1f} us; the "
                f"streaming body {stream_us or '-'} us; plain "
                f"{t_p * 1e3:9.1f} us, bf16 matmul {t_lib * 1e3:7.1f} us, "
                f"bound {r['bound_ms'] * 1e3:6.1f} us by {r['bound_by']}; "
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
        scale = float(want.abs().max()) if want.numel() else 0.0
        ok = err <= KERNEL_REL_TOL * scale + KERNEL_ABS_TOL
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
def _roll(torch, cfg, params, toks, device, cache=None):
    """Teacher-forced decode of ``toks`` (B, S) from an empty cache (or
    ``cache``, e.g. Whisper's primed one) -> float32 logits (B, S, V)."""
    from repro_torch.models.factory import decode_step, init_cache
    if cache is None:
        cache = init_cache(cfg, toks.shape[0], toks.shape[1] + 4,
                           device=device)
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
    from repro_torch.convert import cast_params
    torch, dev = ctx["torch"], ctx["device"]
    gen = torch.Generator().manual_seed(ctx["seed"] + 7)
    toks = torch.randint(0, cfg.vocab_size, (b, 2 * steps), generator=gen,
                         dtype=torch.int32)
    cfg32 = cfg_fp.replace(param_dtype="float32", compute_dtype="float32")
    p32 = cast_params(params_fp, dtype=torch.float32)
    card = _roll(torch, cfg32, p32, toks[:, :steps], dev).cpu()
    cpu = _roll(torch, cfg32, cast_params(p32, device="cpu"),
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
        f"{wall:.2f} s, no ESPIM kernel launched, arena clean")
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


def _drill_launches(label: str, kernels) -> dict:
    """The launch counts of kernels 1-4 since the last reset; each kernel
    of the drill's pack must have launched."""
    launches = {k: v for k, v in read_launches().items()
                if k in FP_KERNELS + INT8_KERNELS}
    for k in kernels:
        need(launches[k] > 0, f"[{label}] kernel {k} never launched")
    return launches


def _share(n_equal: int, n: int) -> float:
    return n_equal / n if n else 1.0


def robust_fault_drill(ctx, cfg, params, sparse8) -> dict:
    """``run_fault_drill`` over all eight kinds on the int8 packs."""
    from repro_torch.serve import faults as F
    reset_launches()
    t0 = time.perf_counter()
    d = F.run_fault_drill(cfg, params, sparse8, seed=ctx["seed"],
                          impl=ctx["impl"], device=ctx["device"])
    wall = time.perf_counter() - t0
    launches = _drill_launches("fault drill", INT8_KERNELS)
    fl = d["faults"]
    for kind in F.LOAD_FAULTS:
        need(fl[kind]["rejected_at_load"],
             f"[fault drill] {kind} was not rejected at load")
    rows = {}
    for kind in F.FAULT_KINDS:
        r = fl[kind]
        if kind in F.LOAD_FAULTS:
            rows[kind] = {"rejected_at_load": True}
            continue
        need(r["states"].get("failed", 0) == 0,
             f"[fault drill] {kind}: requests failed: {r['states']}")
        need(r["leaked_blocks"] == 0,
             f"[fault drill] {kind}: {r['leaked_blocks']} blocks leaked")
        rows[kind] = {k: r[k] for k in (
            "states", "tokens", "degraded_tokens", "quarantines", "retries",
            "watchdog_flags", "unaffected_parity", "tokens_compared",
            "tokens_equal_baseline", "wall_s", "recovery_s")}
    need(fl["nonfinite_logits"]["quarantines"] >= 1,
         "[fault drill] nonfinite_logits: the guard never tripped")
    need(fl["transient_step_error"]["retries"] >= 1,
         "[fault drill] transient_step_error: no retry")
    need(fl["latency_spike"]["watchdog_flags"] >= 1,
         "[fault drill] latency_spike: the watchdog stayed silent")
    need(fl["abort_mid_decode"]["states"].get("cancelled", 0) == 1,
         f"[fault drill] abort_mid_decode: states "
         f"{fl['abort_mid_decode']['states']}")
    log(f"[robust:fault] {len(F.FAULT_KINDS)} kinds on the int8 packs in "
        f"{wall:.2f} s: load faults rejected; launches {launches}")
    for kind, r in rows.items():
        if kind in F.LOAD_FAULTS:
            continue
        log(f"[robust:fault]   {kind:22s} states {r['states']}, "
            f"quarantines {r['quarantines']}, retries {r['retries']}, "
            f"watchdog {r['watchdog_flags']}, degraded tokens "
            f"{r['degraded_tokens']}; unaffected parity "
            f"{r['unaffected_parity']}, {r['tokens_equal_baseline']}/"
            f"{r['tokens_compared']} tokens equal the baseline's")
    return {"kinds": rows, "baseline": d["baseline"], "wall_s": wall,
            "launches": launches}


def _need_resumed(label: str, share: float, n_equal: int, n: int) -> None:
    need(share >= RESUME_EQUAL_MIN,
         f"[{label}] {n_equal}/{n} tokens after the interruption equal the "
         f"uninterrupted run's (< {RESUME_EQUAL_MIN:.0%})")


def robust_crash_drill(ctx, cfg_fp, params_fp, sparse_fp) -> dict:
    """``run_crash_drill`` on the 1-layer fp32 packs, killed at the middle
    step of the uninterrupted run."""
    import numpy as np

    from repro_torch.serve import engine as E
    from repro_torch.serve import faults as F
    kw = dict(batch_slots=2, max_len=64, block_size=8, prefill_chunk=8)
    # the drill's own trace through one engine gives its step count
    probe = E.ServeEngine(cfg_fp, params_fp, sparse=sparse_fp,
                          impl=ctx["impl"], device=ctx["device"], **kw)
    total = 0
    reqs = F._drill_requests(cfg_fp, np.random.default_rng(ctx["seed"]), 4,
                             8)
    for r in reqs:
        probe.submit(r)
    while probe.scheduler.has_pending or any(
            s is not None for s in probe.slots):
        probe.step()
        total += 1
    reset_launches()
    t0 = time.perf_counter()
    d = F.run_crash_drill(cfg_fp, params_fp, sparse_fp, seed=ctx["seed"],
                          impl=ctx["impl"], device=ctx["device"],
                          kill_step=total // 2, **kw)
    wall = time.perf_counter() - t0
    launches = _drill_launches("crash drill", FP_KERNELS)
    need(d["total_steps"] == total,
         f"[crash drill] {d['total_steps']} steps, the probe took {total}")
    need(d["restored_requests"] >= 1
         and d["restored_requests"] == d["in_flight_at_kill"],
         f"[crash drill] restored {d['restored_requests']} of "
         f"{d['in_flight_at_kill']} in flight")
    need(d["states"] == {"completed": d["restored_requests"]},
         f"[crash drill] states {d['states']}")
    need(d["leaked_blocks"] == 0,
         f"[crash drill] {d['leaked_blocks']} blocks leaked")
    share = _share(d["tokens_after_kill_equal"], d["tokens_after_kill"])
    log(f"[robust:crash] fp32 packs, killed at step {d['kill_step']}/"
        f"{d['total_steps']}: {d['restored_requests']} restored, states "
        f"{d['states']}, arena clean; {d['tokens_after_kill_equal']}/"
        f"{d['tokens_after_kill']} tokens after the kill equal the "
        f"uninterrupted run's; exact parity {d['exact_parity']}; snapshot "
        f"{d['snapshot_bytes']} B; recovery {d['recovery_s']:.3f} s; "
        f"{wall:.2f} s; launches {launches}")
    _need_resumed("crash drill", share, d["tokens_after_kill_equal"],
                  d["tokens_after_kill"])
    rec = {k: d[k] for k in ("kill_step", "total_steps", "in_flight_at_kill",
                             "restored_requests", "exact_parity", "states",
                             "leaked_blocks", "snapshot_bytes", "recovery_s",
                             "first_new_token_s", "tokens_after_kill",
                             "tokens_after_kill_equal")}
    return dict(rec, share_equal=share, wall_s=wall, launches=launches)


def robust_preemption(ctx, cfg, params, sparse8) -> dict:
    """The int8 engine with an arena of exactly the long request's
    worst-case blocks: a short request arriving 3 ticks later preempts
    it; both finish, against an engine with a roomy arena."""
    import numpy as np

    from repro_torch.serve import engine as E
    kw = dict(batch_slots=2, max_len=48, block_size=8, prefill_chunk=8,
              validate_arena=True, impl=ctx["impl"], device=ctx["device"])
    rng = np.random.default_rng(ctx["seed"] + 7)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (6, 4)]

    def run(num_blocks):
        eng = E.ServeEngine(cfg, params, sparse=sparse8,
                            num_blocks=num_blocks, **kw)
        first = {}
        inner = eng._preempt_slot

        def spy(i):                     # tokens committed at the preempt
            st = inner(i)
            first.setdefault(st.req.rid, len(st.req.output))
            return st
        eng._preempt_slot = spy
        reqs = [E.Request(rid=i, prompt=p, max_new_tokens=m)
                for i, (p, m) in enumerate(zip(prompts, (14, 3)))]
        eng.submit(reqs[0])
        for _ in range(3):
            eng.step()
        eng.submit(reqs[1])
        eng.run()
        return eng, reqs, first

    base, base_reqs, _ = run(None)
    need(base.stats.preempts == 0, "[preempt] the roomy arena preempted")
    reset_launches()
    t0 = time.perf_counter()
    eng, reqs, first = run(-(-(len(prompts[0]) + 14 + 1) // 8))
    wall = time.perf_counter() - t0
    launches = _drill_launches("preempt", INT8_KERNELS)
    st = eng.stats
    states = st.latency_summary()["states"]
    need(st.preempts >= 1, "[preempt] the tight arena never preempted")
    need(states == {"completed": 2}, f"[preempt] states {states}")
    eng.check_arena()
    need(eng.cache.free_blocks == eng.cache.num_blocks,
         "[preempt] blocks leaked")
    after = [(a, b) for r, br in zip(reqs, base_reqs) if r.rid in first
             for a, b in zip(r.output[first[r.rid]:],
                             br.output[first[r.rid]:])]
    n_eq = sum(a == b for a, b in after)
    all_eq = sum(a == b for r, br in zip(reqs, base_reqs)
                 for a, b in zip(r.output, br.output))
    n_all = sum(len(r.output) for r in reqs)
    log(f"[robust:preempt] int8 packs, arena {eng.cache.num_blocks} "
        f"blocks: {st.preempts} preempts, states {states}, arena clean; "
        f"{n_eq}/{len(after)} tokens after the preemption equal the "
        f"roomy run's ({all_eq}/{n_all} of all); {wall:.2f} s; launches "
        f"{launches}")
    _need_resumed("preempt", _share(n_eq, len(after)), n_eq, len(after))
    return {"preempts": st.preempts, "states": states,
            "num_blocks": eng.cache.num_blocks,
            "tokens_after_preempt": len(after),
            "tokens_after_preempt_equal": n_eq, "tokens_equal": all_eq,
            "tokens": n_all, "wall_s": wall, "launches": launches}


def robust_overload_drill(ctx, cfg, params, sparse8) -> dict:
    """``run_overload_drill`` on the int8 packs: a 2x Poisson burst."""
    from repro_torch.serve import faults as F
    reset_launches()
    t0 = time.perf_counter()
    d = F.run_overload_drill(cfg, params, sparse8, seed=ctx["seed"],
                             impl=ctx["impl"], device=ctx["device"])
    wall = time.perf_counter() - t0
    launches = _drill_launches("overload drill", INT8_KERNELS)
    try:
        F.check_overload_drill(d)
    except AssertionError as e:
        raise SmokeFailure(f"[overload drill] {e}") from None
    log(f"[robust:overload] {d['scale']['n_requests']} requests at "
        f"{d['factor']}x: {d['sheds']} shed, {d['preempts']} preempted, "
        f"states {d['states']}, {d['tokens']} tokens, max queue "
        f"{d['max_queue_depth_seen']}, {d['steps']} steps, goodput under "
        f"SLO {d['goodput_tok_s_under_slo']:.1f} tok/s; {wall:.2f} s; "
        f"launches {launches}")
    return dict({k: d[k] for k in ("states", "tokens", "sheds", "preempts",
                                   "steps", "max_queue_depth_seen",
                                   "goodput_tok_s_under_slo", "scale")},
                wall_s=wall, launches=launches)


def robust_replay(ctx, cfg, params, sparse8, prompts, eng8) -> dict:
    """The 8-request trace through ``prefill_mode="replay"``: every prompt
    token through the decode step, against the chunked run of the engine
    phase."""
    from repro_torch.serve import engine as E
    from repro_torch.serve.scheduler import latency_summary
    eng = E.ServeEngine(cfg, params, sparse=sparse8, prefill_mode="replay",
                        impl=ctx["impl"], device=ctx["device"], **ENGINE_KW)
    serve(E, eng, [prompts[0][:3]], 2)                 # warm-up request
    eng.reset_stats()
    reset_launches()
    reqs, stats, wall = serve(E, eng, prompts, MAX_NEW)
    launches = _drill_launches("replay", INT8_KERNELS)
    _need_clean_finish("replay", eng, reqs)
    need(stats.prefill_chunks == 0, "[replay] a prefill chunk ran")
    n_prompt = sum(len(p) for p in prompts)
    slots = ENGINE_KW["batch_slots"]
    rise, per_tick = {}, {}
    for k in INT8_KERNELS:
        rise[k] = launches[k] - eng8["launches"][k]
        per_tick[k] = round(eng8["launches_per_decode_step"][k])
        # a decode tick feeds one token of each of at most `slots` slots,
        # so the prompt tokens take at least n_prompt / slots more ticks
        need(rise[k] >= -(-n_prompt // slots) * per_tick[k],
             f"[replay] kernel {k} rose by {rise[k]} launches for "
             f"{n_prompt} prompt tokens ({per_tick[k]} a tick)")
    equal = sum(a == b for r, base in zip(reqs, eng8["outputs"])
                for a, b in zip(r.output, base))
    lat = latency_summary(stats.requests)
    ttft = lat["ttft_s"]["p50"]
    log(f"[robust:replay] {len(prompts)} requests, {n_prompt} prompt tokens "
        f"x {cfg.n_layers} layers through decode: {stats.decode_steps} "
        f"decode steps against {eng8['decode_steps']} chunked; launches "
        + ", ".join(f"{k} +{rise[k]} ({per_tick[k]} a tick)"
                    for k in INT8_KERNELS)
        + f"; {equal}/{stats.tokens_generated} tokens equal the chunked "
        f"run's; TTFT p50 {ttft * 1e3:.1f} ms against "
        f"{eng8['ttft_p50_s'] * 1e3:.1f} ms chunked; {wall:.2f} s")
    return {"decode_steps": stats.decode_steps,
            "chunked_decode_steps": eng8["decode_steps"],
            "prompt_tokens": n_prompt, "launches": launches,
            "launch_rise": rise, "launches_per_tick": per_tick,
            "tokens_equal_chunked": equal, "tokens": stats.tokens_generated,
            "ttft_p50_s": ttft, "chunked_ttft_p50_s": eng8["ttft_p50_s"],
            "tpot_p50_s": lat["tpot_s"]["p50"], "wall_s": wall}


def batch_invariance(ctx, sparse8, sparse_fp) -> dict:
    """Kernels 1-4 give a column the same bits at B = 1 as inside B = 4
    (the drills' parity assumes greedy decode is batching-independent):
    every engine-pack case, per bucket and grouped, each of the 4 columns
    alone."""
    from repro_torch.kernels import ops
    torch, dev = ctx["torch"], ctx["device"]
    gen = torch.Generator(device=dev).manual_seed(ctx["seed"] + 8)
    out = {}
    runs = [(c, run_case) for c in kernel_cases(ctx, sparse8, sparse_fp)
            if c["kernel"] in FP_KERNELS + INT8_KERNELS
            and c["variant"] in ("fp32", "int8")]
    runs += [(gc, run_group) for gc in group_cases(ctx, sparse8, sparse_fp)
             if gc["variant"] in ("fp32", "int8")]
    for c, run in runs:
        x = torch.randn((c["m"], 4), generator=gen, device=dev)
        y4 = run(ops, c, x, ctx["impl"])
        key = c["kernel"] + (" grouped" if run is run_group else "")
        rec = out.setdefault(key, {"columns": 0, "identical": 0,
                                   "max_abs_diff": 0.0})
        for j in range(4):
            y1 = run(ops, c, x[:, j:j + 1].contiguous(), ctx["impl"])
            rec["columns"] += 1
            rec["identical"] += bool(torch.equal(y1[:, 0], y4[:, j]))
            rec["max_abs_diff"] = max(rec["max_abs_diff"], float(
                (y1[:, 0] - y4[:, j]).abs().max()))
    log("[robust:batch] a column alone (B=1) against inside B=4: "
        + "; ".join(f"{k} {r['identical']}/{r['columns']} bit-identical, "
                    f"max|diff| {r['max_abs_diff']:.3e}"
                    for k, r in out.items()))
    for k, r in out.items():
        need(r["identical"] == r["columns"],
             f"[robust:batch] {k}: {r['columns'] - r['identical']} of "
             f"{r['columns']} columns differ alone from inside B = 4")
    return out


def fused_vs_unfused(ctx, label, cfg, params, sparse, b=4) -> dict:
    """One decode step with the GLU epilogue in the gate+up launch against
    the step with it applied by separate ops (the grouped launch over the
    gate+up planes, then act(gate) * up): logits and caches in bits."""
    from repro_torch.core.sparse_model import decode_step_sparse
    from repro_torch.models.transformer import init_cache
    torch, dev = ctx["torch"], ctx["device"]
    gen = torch.Generator().manual_seed(ctx["seed"] + 11)
    toks = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                         dtype=torch.int32).to(dev)
    c0 = init_cache(cfg, b, 8, device=dev)
    outs = [decode_step_sparse(cfg, params, sparse, c0, {"tokens": toks},
                               impl=ctx["impl"], epilogue=ep, device=dev)
            for ep in (True, False)]
    same = {"logits": torch.equal(outs[0][0], outs[1][0]),
            "k": torch.equal(outs[0][1]["k"], outs[1][1]["k"]),
            "v": torch.equal(outs[0][1]["v"], outs[1][1]["v"])}
    diff = float((outs[0][0].float() - outs[1][0].float()).abs().max())
    log(f"[parity:{label}] fused against unfused GLU epilogue, B={b}: "
        f"{same}, max|logits diff| {diff:.3e}")
    need(all(same.values()), f"[parity:{label}] the fused GLU epilogue "
         f"changed the step's bits: {same}")
    return {"bit_identical": same, "max_abs_logit_diff": diff}


def robust_launcher(ctx) -> dict:
    """``python -m repro_torch.launch.serve`` at llama7b-espim's full depth
    and width, as a subprocess of its own."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *LAUNCHER_ARGS]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=LAUNCHER_TIMEOUT_S,
                              env=dict(os.environ, PYTHONPATH=str(SRC)))
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"[launcher] {' '.join(cmd[1:])} ran past "
                           f"{LAUNCHER_TIMEOUT_S} s") from None
    wall = time.perf_counter() - t0
    need(proc.returncode == 0, f"[launcher] exit {proc.returncode}: "
         f"{proc.stderr.strip()[-2000:]}")
    m = re.search(r"completed (\d+) requests, (\d+) tokens in ([\d.]+)s "
                  r"\(([\d.]+) tok/s", proc.stdout)
    need(m is not None, f"[launcher] no summary in {proc.stdout!r}")
    n_req, n_tok = int(m.group(1)), int(m.group(2))
    need((n_req, n_tok) == (4, 32),
         f"[launcher] {n_req} requests, {n_tok} tokens (want 4, 32)")
    log(f"[robust:launcher] {' '.join(cmd[1:])}: {proc.stdout.strip()}; "
        f"{wall:.1f} s with the process start and the params")
    return {"requests": n_req, "tokens": n_tok, "serve_s": float(m.group(3)),
            "tok_per_s": float(m.group(4)), "wall_s": wall,
            "stdout": proc.stdout.strip()}


def phase_robustness(ctx, cfg, params, cfg_fp, params_fp, sparse8,
                     sparse_fp, prompts, eng8) -> None:
    """The serving engine's overload, crash and fault ladder on the card:
    the fault drill (int8), the crash drill (fp32), preemption (int8), the
    overload drill (int8), replay prefill (int8), the batch-invariance
    check of kernels 1-4 and the full-depth launcher."""
    t0 = time.perf_counter()
    rec = {"fault": robust_fault_drill(ctx, cfg, params, sparse8),
           "crash": robust_crash_drill(ctx, cfg_fp, params_fp, sparse_fp),
           "preempt": robust_preemption(ctx, cfg, params, sparse8),
           "overload": robust_overload_drill(ctx, cfg, params, sparse8),
           "replay": robust_replay(ctx, cfg, params, sparse8, prompts, eng8),
           "batch_invariance": batch_invariance(ctx, sparse8, sparse_fp),
           "launcher": robust_launcher(ctx)}
    rec["seconds"] = time.perf_counter() - t0
    log(f"[robust] phase in {rec['seconds']:.1f} s")
    ctx["report"]["robustness"] = rec


def mv_checks(ctx, weights: dict) -> dict:
    """Kernel 5 beyond its timed cases, on the projection phase's fp32
    packs (``weights``: {"qkv", "down"}), each case against its plain
    version under ``_within`` and launched twice for the same bits: both
    mixed dtypes (f32 values with a bf16 x, bf16 values with an f32 x);
    an Lc that is not a multiple of 4 in every dtype pair; a pack of
    ``MV_FEW_ROWS`` rows; x of 65536 f32 columns (``MV_WIDE``); R = 0,
    which the wrapper answers with zeros and no launch.  Then
    ``MV_SLICE``'s rows launched alone equal the same rows of the whole
    launch in bits, on the qkv pack and the odd-Lc pack.  These launches
    compare; they count toward no phase."""
    from repro_torch.kernels import espim_spmv as K
    from repro_torch.kernels import ops
    torch, dev = ctx["torch"], ctx["device"]
    gen = torch.Generator(device=dev).manual_seed(ctx["seed"] + 6)
    f32, bf = torch.float32, torch.bfloat16
    names = {f32: "fp32", bf: "bf16"}
    qkv, down = weights["qkv"], weights["down"]
    # (values, cols, chunk_cols, x's length) of each pack
    odd = (down.values[:, :, :MV_ODD_LC].contiguous(),
           down.cols[:, :, :MV_ODD_LC].contiguous(), down.chunk_cols,
           down.n_cols)
    r, m, lc = MV_WIDE
    cc = qkv.chunk_cols
    wide = (torch.randn((r, m // cc, lc), generator=gen, device=dev),
            torch.randint(0, cc, (r, m // cc, lc), generator=gen, device=dev,
                          dtype=torch.int32), cc, m)
    packs = {"qkv": (qkv.values, qkv.cols, cc, qkv.n_cols),
             "down": (down.values, down.cols, down.chunk_cols, down.n_cols),
             f"Lc {MV_ODD_LC}": odd,
             f"{MV_FEW_ROWS} rows": (qkv.values[:MV_FEW_ROWS].contiguous(),
                                     qkv.cols[:MV_FEW_ROWS].contiguous(), cc,
                                     qkv.n_cols),
             f"{m} columns": wide,
             "R 0": (qkv.values[:0], qkv.cols[:0], cc, qkv.n_cols)}
    # (pack, value dtype, x dtype)
    cases = ([(p, f32, bf) for p in ("qkv", "down")]
             + [(p, bf, f32) for p in ("qkv", "down")]
             + [(f"Lc {MV_ODD_LC}", vd, xd) for vd in (f32, bf)
                for xd in (f32, bf)]
             + [(f"{MV_FEW_ROWS} rows", f32, f32), (f"{MV_FEW_ROWS} rows", bf, bf),
                (f"{m} columns", f32, f32), ("R 0", f32, f32)])
    rows, worst = [], 0.0
    for pack, vd, xd in cases:
        vals, cols, ccp, n_x = packs[pack]
        vals = vals.to(vd)
        x = torch.randn((n_x,), generator=gen, device=dev).to(xd)
        run = (lambda impl, v=vals, c=cols, x=x, cc=ccp:
               ops.espim_spmv(v, c, x, chunk_cols=cc, impl=impl))
        before = K.LAUNCHES["espim_spmv"]
        got, again = run(None), run(None)
        launched = K.LAUNCHES["espim_spmv"] - before
        need(launched == (0 if pack == "R 0" else 2),
             f"[kernels] espim_spmv {pack}: {launched} launches for two "
             f"calls")
        want = run("ref")
        variant = f"{names[vd]} values, {names[xd]} x"
        ok, err = _within("espim_spmv", variant, got, want)
        need(ok, f"[kernels] espim_spmv {pack} {variant}: max|kernel-plain| "
             f"{err:.3e} out of tolerance")
        need(torch.equal(got, again), f"[kernels] espim_spmv {pack} "
             f"{variant}: two launches gave different bits")
        worst = max(worst, err)
        rows.append({"pack": pack, "variant": variant,
                     "shape": list(cols.shape), "max_abs_err": err})
    lo, hi = MV_SLICE
    for pack in ("qkv", f"Lc {MV_ODD_LC}"):
        vals, cols, ccp, n_x = packs[pack]
        for vd in (f32, bf):
            v = vals.to(vd)
            x = torch.randn((n_x,), generator=gen, device=dev).to(vd)
            whole = ops.espim_spmv(v, cols, x, chunk_cols=ccp)
            part = ops.espim_spmv(v[lo:hi], cols[lo:hi], x, chunk_cols=ccp)
            need(torch.equal(part, whole[lo:hi]),
                 f"[kernels] espim_spmv {pack} {names[vd]}: rows {lo}:{hi} "
                 f"launched alone differ from the whole launch's")
            rows.append({"pack": pack, "variant": f"{names[vd]} rows "
                         f"{lo}:{hi} alone == whole", "max_abs_err": 0.0})
    log(f"[kernels] espim_spmv: {len(cases)} more cases (mixed dtypes, Lc "
        f"{MV_ODD_LC}, {MV_FEW_ROWS} rows, x of {m} f32 columns in pieces; "
        f"R 0 as zeros with no launch) within the fp32 rule and repeating "
        f"their bits, worst "
        f"max|kernel-plain| {worst:.2e}; rows {lo}:{hi} alone == the whole "
        f"launch's in bits (qkv and Lc {MV_ODD_LC}, fp32 and bf16)")
    return {"cases": rows, "worst": worst}


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


# --------------------------------------------------------------------------
# decode attention: RoPE, the cache write and the attention in one launch
# --------------------------------------------------------------------------
def _decode_attn_lens(torch, b: int, kind: str, gen):
    """(B,) int32 rows of the new tokens: every row live ("full"), one
    sequence a length of the chat mix ("chat": log-normal, median 400,
    32 to the last row), or the test's edges and random rows ("mix")."""
    s = DECODE_ATTN_S
    if kind == "full":
        return torch.full((b,), s - 1, dtype=torch.int32)
    if kind == "chat":
        ln = torch.exp(math.log(400) + 0.6 * torch.randn(b, generator=gen))
        return ln.clamp(32, s - 1).to(torch.int32)
    edges = [0, 1, 7, 8, 9, 191, 192, 193, s - 2, s - 1]
    rest = torch.randint(0, s, (b,), generator=gen).tolist()
    return torch.tensor((edges + rest)[:b], dtype=torch.int32)


def _event_ms(torch, fn, reps: int = 20, trials: int = 5) -> float:
    """Median ms of device time per call of ``fn`` between two CUDA
    events around ``reps`` calls, for work no graph can capture; the
    host's launch gaps count where the device outruns it."""
    fn()
    out = []
    for _ in range(trials):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def phase_decode_attention(ctx) -> dict:
    """The decode attention kernel against its plain version at
    ``DECODE_ATTN_CASES`` (bf16, S ``DECODE_ATTN_S``): the caches after a
    launch in the plain version's bits, the output within the test's
    rule (``tests/test_torch_decode_attention.py``: 2^-7 of each element
    + 2^-10 of the largest) and in the same bits on a second launch, one
    count a launch; then timed (each launch after a read that evicts the
    50 MB L2, less the read) beside the plain version,
    ``scaled_dot_product_attention`` over the same rows (a yardstick the
    port never calls; the plain version by events around 20 calls, as no
    graph captures its copy of theta) and the bound: the live rows' K / V, q, the new
    rows and the output once each at 3.35 TB/s, or 4 H hd operations a
    live row at 67 TFLOP/s float32."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    torch, timer, bw, dev = (ctx["torch"], ctx["timer"], ctx["bandwidth"],
                             ctx["device"])
    gen = torch.Generator().manual_seed(ctx["seed"] + 34)
    flush = torch.ones(32 << 20, device=dev)
    t_flush = timer(flush.sum)
    rows, worst = [], 0.0
    for label, b, h, kvh, hd, kind in DECODE_ATTN_CASES:
        s = DECODE_ATTN_S
        lens = _decode_attn_lens(torch, b, kind, gen).to(dev)

        def r(*shape):
            return torch.randn(shape, generator=gen).to(
                torch.bfloat16).to(dev)

        q, k, v = r(b, 1, h, hd), r(b, 1, kvh, hd), r(b, 1, kvh, hd)
        kc, vc = r(b, s, kvh, hd), r(b, s, kvh, hd)
        want, wk, wv = DA.decode_attention_ref(q, k, v, kc, vc, lens, 1e4,
                                               True)
        DA.reset_launches()
        got = []
        for _ in range(2):
            gk, gv = kc.clone(), vc.clone()
            got.append(DA.decode_attention_cuda(q, k, v, gk, gv, lens, 1e4))
            torch.cuda.synchronize()
            need(torch.equal(gk, wk) and torch.equal(gv, wv),
                 f"[decode_attn] {label}: the caches after the launch are "
                 "not the plain version's bits")
        need(DA.LAUNCHES["decode_attention"] == 2 * DA.KERNELS_A_CALL,
             f"[decode_attn] {label}: {DA.LAUNCHES} kernel launches for 2 "
             "calls")
        need(torch.equal(got[0], got[1]), f"[decode_attn] {label}: two "
             "launches on the same inputs gave different bits")
        diff = (got[0].float() - want.float()).abs()
        scale = float(want.float().abs().max())
        err = float(diff.max())
        need(bool((diff <= DECODE_ATTN_REL * want.float().abs()
                   + DECODE_ATTN_ABS * scale).all()),
             f"[decode_attn] {label}: max|kernel-plain| {err:.3e} out of "
             f"the rule (max|plain| {scale:.3e})")
        worst = max(worst, err / scale)
        live = int(torch.clamp(lens.long() + 1, max=s).sum())
        esz = 2
        nbytes = esz * (2 * live * kvh * hd + 2 * b * h * hd
                        + 2 * b * kvh * hd + 2 * b * kvh * hd) + 4 * b
        flops = 4 * h * hd * live
        mask = (torch.arange(s, device=dev)[None] <= lens[:, None].long())
        mask = mask[:, None, None, :]                       # (B, 1, 1, S)

        def lib():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)

        t_k = timer(lambda: (flush.sum(), DA.decode_attention_cuda(
            q, k, v, kc, vc, lens, 1e4))) - t_flush
        # the plain version copies theta to the card: no graph captures it
        t_p = _event_ms(torch, lambda: (flush.sum(), DA.decode_attention_ref(
            q, k, v, kc, vc, lens, 1e4, True))) - _event_ms(torch, flush.sum)
        t_l = timer(lambda: (flush.sum(), lib())) - t_flush
        t_bytes, t_ops = nbytes / bw * 1e3, flops / PEAKS["fp32"] * 1e3
        row = {"case": label, "B": b, "H": h, "KV": kvh, "hd": hd,
               "S": s, "lens": kind, "live_rows": live, "ms": t_k,
               "plain_ms": t_p, "library_ms": t_l,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "flops": flops,
               "achieved_GBps": nbytes / (t_k * 1e-3) / 1e9,
               "max_abs_err": err, "max_abs_plain": scale}
        rows.append(row)
        log(f"[decode_attn] {label:10s} B {b} H {h}/{kvh} hd {hd} S {s} "
            f"{kind} ({live} live rows): {t_k * 1e3:7.1f} us (plain "
            f"{t_p * 1e3:8.1f}, SDPA {t_l * 1e3:7.1f}, bound "
            f"{row['bound_ms'] * 1e3:6.1f} us by {row['bound_by']}; "
            f"{row['achieved_GBps']:.0f} GB/s); max|kernel-plain| "
            f"{err:.2e} of max|plain| {scale:.2e}; caches in bits")
    ctx["report"]["decode_attention"] = rows
    return {"rows": rows, "worst_rel": worst}


# --------------------------------------------------------------------------
# the other model families: forward on kernel 8, decode, serving
# --------------------------------------------------------------------------
def _depth(cfg, n):
    """``cfg`` cut to ``n`` layers (Whisper: ``n`` encoder layers too)."""
    if n is None:
        return cfg
    kw = {"n_layers": n}
    if cfg.encoder_layers:
        kw["encoder_layers"] = n
    return cfg.replace(**kw)


def _depth_params(params: dict, n) -> dict:
    """The first ``n`` layers of every stacked layer tree."""
    def cut(tree):
        return {k: (cut(v) if isinstance(v, dict) else v[:n])
                for k, v in tree.items()}
    return {k: (cut(v) if k in ("layers", "enc_layers", "dec_layers")
                else v) for k, v in params.items()}


def wkv_expected(cfg) -> int:
    """WKV forward launches of one forward, prefill chunk or decode step:
    one a layer for rwkv6, none for the other families."""
    return cfg.n_layers if cfg.family == "ssm" else 0


def kernel8_expected(cfg) -> int:
    """Kernel 8 launches of one ``prefill_fn`` (and, for Whisper, one
    ``prime_cross``): one per equal-length attention of the forward."""
    if cfg.family == "audio":       # prime_cross's encoder + the forward's
        return 2 * cfg.encoder_layers + cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers


def _primed_cache(cfg, params, b, max_len, frames, device):
    from repro_torch.models import factory, whisper
    cache = factory.init_cache(cfg, b, max_len, device=device)
    if cfg.family == "audio":
        cache = whisper.prime_cross(cfg, params, cache, frames.to(device))
    return cache


def family_decode_vs_forward(ctx, cfg, params, toks, frames) -> dict:
    """(a) ``prefill_fn`` (kernel 8) against teacher-forced decode, fp32;
    kernel 8's counter zeroed before the forward and the priming and
    read after."""
    from repro_torch.serve.serve_step import prefill_fn
    torch, dev = ctx["torch"], ctx["device"]
    batch = {"tokens": toks.to(dev)}
    if frames is not None:
        batch["frames"] = frames.to(dev)
    reset_launches()
    fwd = prefill_fn(cfg, params, batch).float()
    cache = _primed_cache(cfg, params, toks.shape[0], toks.shape[1] + 4,
                          frames, dev)
    torch.cuda.synchronize()
    launches = read_launches()
    want, want_wkv = kernel8_expected(cfg), wkv_expected(cfg)
    need(launches["flash_attention"] == want
         and launches["wkv6"] == want_wkv
         and sum(launches.values()) == want + want_wkv,
         f"[families:{cfg.name}] launches {launches}, want kernel 8 "
         f"{want} times, the WKV forward {want_wkv} and no other kernel")
    dec = _roll(torch, cfg, params, toks, dev, cache)
    err = float((dec - fwd).abs().max() / fwd.abs().max())
    need(bool(torch.isfinite(fwd).all()) and err <= FAMILY_REL_TOL,
         f"[families:{cfg.name}] decode vs forward {err:.3e} > "
         f"{FAMILY_REL_TOL}")
    return {"rel_err": err, "kernel8_launches": launches["flash_attention"],
            "kernel8_expected": want, "wkv6_launches": launches["wkv6"]}


def family_conditioning(ctx, cfg, params, toks) -> dict:
    """Decode against forward at the model's whole depth, in fp32 and in
    float64 (reported, not required): how far two orders of the same
    sums drift apart through the layers.  The float64 run keeps the
    float32 leaves and rwkv6's float32 WKV recurrence."""
    from repro_torch.convert import cast_params
    from repro_torch.serve.serve_step import prefill_fn
    torch, dev = ctx["torch"], ctx["device"]
    out = {}
    for name, dt in (("fp32", "float32"), ("fp64", "float64")):
        c = cfg.replace(param_dtype=dt, compute_dtype=dt)
        p = cast_params(params, dtype=getattr(torch, dt))
        fwd = prefill_fn(c, p, {"tokens": toks.to(dev)}).double()
        dec = _roll(torch, c, p, toks, dev).double()
        out[name] = float((dec - fwd).abs().max() / fwd.abs().max())
        del p
    return out


def family_card_vs_cpu(ctx, cfg, params, toks, frames, depth) -> dict:
    """(b) teacher-forced fp32 decode at depth ``depth`` on the card and
    on the CPU."""
    from repro_torch.convert import cast_params
    torch, dev = ctx["torch"], ctx["device"]
    cfg_d, p_d = _depth(cfg, depth), _depth_params(params, depth)
    toks = toks[:, :FAMILY_CPU_STEPS]
    out = {}
    for where, p in ((dev, p_d), ("cpu", cast_params(p_d, device="cpu"))):
        cache = _primed_cache(cfg_d, p, toks.shape[0], toks.shape[1] + 4,
                              frames, where)
        out[str(where)] = _roll(torch, cfg_d, p, toks, where, cache).cpu()
    card, cpu = out[str(dev)], out["cpu"]
    err, scale = float((card - cpu).abs().max()), float(cpu.abs().max())
    need(bool(torch.isfinite(card).all())
         and err <= DENSE_LOGIT_REL_TOL * scale,
         f"[families:{cfg.name}] card vs CPU max|diff| {err:.3e} > "
         f"{DENSE_LOGIT_REL_TOL}*{scale:.3e}")
    return {"depth": cfg_d.n_layers, "max_abs": err, "cpu_max_abs": scale}


def family_chunked_vs_replay(ctx, cfg, params, prompt) -> dict:
    """(c) the serving prefiller's chunks (the last padded), then one
    decode step, against token replay: the last prompt position's and the
    first decode step's logits, fp32."""
    from repro_torch.models import factory
    from repro_torch.serve.paged_cache import classify_cache
    from repro_torch.serve.prefill import ChunkedPrefiller
    torch, dev = ctx["torch"], ctx["device"]
    n = FAMILY_PROMPT
    max_len = n + 8
    proto = factory.init_cache(cfg, 1, max_len, device="meta")
    pf = ChunkedPrefiller(cfg, FAMILY_CHUNK, max_len,
                          *classify_cache(proto, max_len), device=dev)
    cache, pos = pf.proto, 0
    while pos < n:
        logits, cache, n_valid = pf.run_chunk(params, cache, prompt[:n], pos)
        pos += n_valid
    got = [logits[:, n_valid - 1].float()]
    lg, _ = factory.decode_step(cfg, params, cache,
                                {"tokens": torch.tensor([[prompt[n]]],
                                                        device=dev)})
    got.append(lg[:, 0].float())
    replay = _roll(torch, cfg, params, torch.tensor([prompt[:n + 1]]), dev)
    errs = [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, (replay[:, n - 1], replay[:, n]))]
    need(max(errs) <= FAMILY_REL_TOL,
         f"[families:{cfg.name}] chunked vs replay {errs} > "
         f"{FAMILY_REL_TOL}")
    return {"last_prompt_rel": errs[0], "first_decode_rel": errs[1],
            "chunks": -(-n // FAMILY_CHUNK)}


def family_engine(ctx, cfg, params) -> dict:
    """(e) ``ServeEngine(sparse=None)`` on the smoke trace (bf16, paged,
    greedy), then one decode step's profile at B = 4.  rwkv6's serve
    launches the WKV forward once a layer a prefill chunk and a decode
    step, and nothing else."""
    from repro_torch.models import factory
    torch = ctx["torch"]
    rng = torch.Generator().manual_seed(ctx["seed"] + 12)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in PROMPT_LENS]
    kernels = ("wkv6",) if wkv_expected(cfg) else ()
    eng = drive_engine(ctx, f"{cfg.name} bf16", cfg, params, None, prompts,
                       kernels, runs=FAMILY_ENGINE_RUNS)
    chunked = factory.supports_chunked_prefill(cfg)
    need((eng["prefill_chunks"] > 0) == chunked,
         f"[families:{cfg.name}] {eng['prefill_chunks']} prefill chunks; "
         f"the family prefills by {'chunks' if chunked else 'replay'}")
    eng["prefill"] = "chunked" if chunked else "replay"
    ticks = eng["decode_steps"] + eng["prefill_chunks"]
    need(eng["launches"]["wkv6"] == wkv_expected(cfg) * ticks,
         f"[families:{cfg.name}] WKV launches {eng['launches']['wkv6']}, "
         f"want {wkv_expected(cfg)} a layer x {ticks} decode steps and "
         "prefill chunks")
    step = decode_step_profile(
        ctx, f"decode_step {cfg.name} bf16", cfg,
        lambda c, b: factory.decode_step(cfg, params, c, b))
    if kernels:
        log(f"[families:{cfg.name}] the WKV as one op: {ticks} prefill "
            f"chunks and decode steps launched it {eng['launches']['wkv6']} "
            f"times ({wkv_expected(cfg)} a step); TTFT p50 "
            f"{eng['ttft_p50_s'] * 1e3:.1f} ms (the per-token loop's "
            f"{LOOP_RWKV6_TTFT_MS} ms), TPOT p50 "
            f"{eng['tpot_p50_s'] * 1e3:.2f} ms; decode step "
            f"{step['kernels_per_step']} kernels, {step['step_ms']:.2f} ms")
    return {"engine": {k: v for k, v in eng.items() if k != "outputs"},
            "step": step}


def _fold(torch, t, h):
    """(B, S, KV, hd) repeated to h heads -> (B·h, S, hd)."""
    from repro_torch.models.layers import repeat_kv
    t = repeat_kv(t, h // t.shape[2])
    return t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3])


def family_kernel8(ctx) -> list:
    """(d) kernel 8 at this slice's shapes through ``layers.flash_attention``
    (GQA repeat and head fold included) against the plain version on the
    repeated heads, twice for identical bits; then the launch alone on
    the folded heads timed beside the plain version and SDPA."""
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models.layers import flash_attention
    torch, dev, timer, bw = (ctx["torch"], ctx["device"], ctx["timer"],
                             ctx["bandwidth"])
    gen = torch.Generator(device=dev).manual_seed(ctx["seed"] + 13)
    whisper = get_config("whisper-small")
    shapes = [("whisper encoder", whisper, whisper.encoder_seq, False)]
    shapes += [(f"{a.split('-')[0]} forward", get_config(a),
                FAMILY_FLASH_SEQ, True)
               for a in ("phi3.5-moe-42b-a6.6b", "qwen2-vl-2b",
                         "zamba2-2.7b")]
    rows = []
    for label, cfg, seq, causal in shapes:
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        for dt, dname in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            q = torch.randn((1, seq, h, hd), generator=gen, device=dev).to(dt)
            k, v = (torch.randn((1, seq, kvh, hd), generator=gen,
                                device=dev).to(dt) for _ in range(2))
            got = flash_attention(q, k, v, causal=causal)
            again = flash_attention(q, k, v, causal=causal)
            qf, kf, vf = (_fold(torch, t, h) for t in (q, k, v))
            want = flash_attention_ref(qf, kf, vf, causal).reshape(
                1, h, seq, hd).transpose(1, 2)
            variant = f"{dname} {label}"
            ok, err = _within("flash_attention", variant, got, want)
            rel = rel_l2(got, want)
            need(ok and torch.equal(got, again),
                 f"[families] kernel 8 {variant}: max|kernel-plain| "
                 f"{err:.3e}, rel L2 {rel:.3e}, or two launches differ")
            t_k = timer(lambda: flash_attention_cuda(qf, kf, vf,
                                                     causal=causal))
            t_p = timer(lambda: flash_attention_ref(qf, kf, vf, causal),
                        reps=3)
            t_lib = timer(lambda: F.scaled_dot_product_attention(
                qf[None], kf[None], vf[None], is_causal=causal))
            pairs = seq * (seq + 1) // 2 if causal else seq * seq
            nbytes = 4 * qf.numel() * qf.element_size()
            flops = 4 * h * hd * pairs
            peak = "tf32x3_tensor" if dname == "fp32" else "bf16_tensor"
            t_bytes, t_ops = nbytes / bw * 1e3, flops / PEAKS[peak] * 1e3
            r = {"variant": variant, "BH": h, "S": seq, "hd": hd,
                 "heads": f"{h}/{kvh}", "causal": causal,
                 "max_abs_err": err, "rel_l2": rel, "ms": t_k,
                 "plain_ms": t_p, "library_ms": t_lib,
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "peak": peak, "bytes": nbytes, "flops": flops}
            rows.append(r)
            log(f"[families] kernel 8 {variant:26s} BH {h} ({h}/{kvh}) S "
                f"{seq} hd {hd} {'causal' if causal else 'full'}: "
                f"max|diff| {err:.2e}, rel L2 {rel:.2e}; {t_k * 1e3:8.1f} us "
                f"(plain {t_p * 1e3:8.1f}, SDPA {t_lib * 1e3:7.1f}, bound "
                f"{r['bound_ms'] * 1e3:6.1f} us by {r['bound_by']})")
    return rows


def family_launchers(ctx) -> dict:
    """(f) ``python -m repro_torch.launch.serve --arch <arch>`` for every
    family at once, each a subprocess of its own; all stopped at the
    time limit."""
    procs = {}
    for arch, *_ in FAMILIES:
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
               arch, *FAMILY_LAUNCHER_ARGS]
        if arch in FAMILY_LAUNCHER_LAYERS:
            cmd += ["--layers", str(FAMILY_LAUNCHER_LAYERS[arch])]
        procs[arch] = (cmd, subprocess.Popen(
            cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(os.environ, PYTHONPATH=str(SRC))))
    t0, out = time.perf_counter(), {}
    try:
        for arch, (cmd, proc) in procs.items():
            left = LAUNCHER_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                stdout, stderr = proc.communicate(timeout=max(1.0, left))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"[families] {' '.join(cmd[1:])} ran past "
                                   f"{LAUNCHER_TIMEOUT_S} s") from None
            need(proc.returncode == 0, f"[families] {' '.join(cmd[3:])}: "
                 f"exit {proc.returncode}: {stderr.strip()[-2000:]}")
            m = re.search(r"completed (\d+) requests, (\d+) tokens in "
                          r"([\d.]+)s \(([\d.]+) tok/s", stdout)
            need(m is not None and (int(m.group(1)), int(m.group(2)))
                 == (4, 32), f"[families] {' '.join(cmd[3:])}: {stdout!r}")
            out[arch] = {"args": cmd[3:], "stdout": stdout.strip(),
                         "tok_per_s": float(m.group(4))}
            log(f"[families:launcher] {' '.join(cmd[3:])}: "
                f"{stdout.strip()}")
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["wall_s"] = time.perf_counter() - t0
    return out


def phase_families(ctx) -> dict:
    """The other model families on the card, (a) to (f); kernel 8 is the
    one kernel their path runs (``layers.flash_attention`` in every
    forward and in Whisper's encoder)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import cast_params
    from repro_torch.models.factory import init_params
    torch, dev = ctx["torch"], ctx["device"]
    t0 = time.perf_counter()
    rec = {"models": {}}
    for arch, depth, cpu_depth, check_depth in FAMILIES:
        t_arch = time.perf_counter()
        full = get_config(arch)
        cfg = _depth(full, depth)
        gen = torch.Generator(device=dev).manual_seed(ctx["seed"] + 11)
        params = init_params(cfg, gen, device=dev)
        n_params = sum(t.numel() for t in _leaves(params))
        cut = ("whole" if depth is None
               else f"{cfg.n_layers} of {full.n_layers} layers")
        log(f"[families] {arch} ({cfg.family}): d_model {cfg.d_model}, "
            f"vocab {cfg.vocab_size}, depth {cut}, {n_params / 1e9:.2f} B "
            f"params in bf16 with the float32 leaves kept")
        cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
        if cfg.family == "moe":
            # a capacity of every token: the forward drops nothing, as the
            # JAX package's reduced config (configs/base.py:140-141)
            cfg32 = cfg32.replace(
                capacity_factor=cfg.n_experts / cfg.experts_per_token)
        p32 = cast_params(params, dtype=torch.float32)
        rng = torch.Generator().manual_seed(ctx["seed"] + 14)
        toks = torch.randint(1, cfg.vocab_size, (FAMILY_B, FAMILY_S),
                             generator=rng, dtype=torch.int32)
        frames = (torch.randn((FAMILY_B, cfg.encoder_seq, cfg.d_model),
                              generator=rng)
                  if cfg.family == "audio" else None)
        r = {"depth": cfg.n_layers, "published_depth": full.n_layers,
             "params": n_params,
             "capacity_factor_fp32": cfg32.capacity_factor}
        cfg_c = _depth(cfg32, check_depth)
        p_c = _depth_params(p32, check_depth)
        r["check_depth"] = cfg_c.n_layers
        r["decode_vs_forward"] = family_decode_vs_forward(ctx, cfg_c, p_c,
                                                          toks, frames)
        r["card_vs_cpu"] = family_card_vs_cpu(ctx, cfg32, p32, toks, frames,
                                              cpu_depth)
        if cfg.family in ("ssm", "hybrid"):
            prompt = torch.randint(1, cfg.vocab_size, (FAMILY_PROMPT + 1,),
                                   generator=rng).tolist()
            r["chunked_vs_replay"] = family_chunked_vs_replay(ctx, cfg_c,
                                                              p_c, prompt)
        if check_depth is not None:
            r["whole_depth_decode_vs_forward"] = family_conditioning(
                ctx, cfg32, params, toks)
        del p32, p_c
        torch.cuda.empty_cache()
        r.update(family_engine(ctx, cfg, params))
        del params
        torch.cuda.empty_cache()
        a, b = r["decode_vs_forward"], r["card_vs_cpu"]
        c, w = r.get("chunked_vs_replay"), r.get("whole_depth_decode_vs_forward")
        log(f"[families:{arch}] (a) decode vs forward fp32 at "
            f"{r['check_depth']} layers {a['rel_err']:.2e}"
            f" (<= {FAMILY_REL_TOL}), kernel 8 launches "
            f"{a['kernel8_launches']}"
            + (f" (MoE capacity factor {cfg32.capacity_factor:g}: no drops)"
               if cfg.family == "moe" else "")
            + f"; (b) card vs CPU at depth {b['depth']} {b['max_abs']:.2e} "
            f"(<= {DENSE_LOGIT_REL_TOL} * {b['cpu_max_abs']:.3f})"
            + (f"; (c) chunked vs replay {c['last_prompt_rel']:.2e} / "
               f"{c['first_decode_rel']:.2e}" if c else "")
            + (f"; at the whole {cfg.n_layers} layers (reported) decode vs "
               f"forward fp32 {w['fp32']:.2e}, float64 {w['fp64']:.2e}"
               if w else "")
            + f"; {time.perf_counter() - t_arch:.1f} s")
        rec["models"][arch] = r
    total = sum(r["decode_vs_forward"]["kernel8_launches"]
                for r in rec["models"].values())
    need(total > 0, "[families] kernel 8 never launched on the path")
    rec["kernel8_launches"] = total
    rec["kernel8"] = family_kernel8(ctx)
    rec["launcher"] = family_launchers(ctx)
    rec["seconds"] = time.perf_counter() - t0
    log(f"[families] kernel 8 launched {total} times by the forwards and "
        f"encodes; phase {rec['seconds']:.1f} s")
    ctx["report"]["families"] = rec
    return rec


# --------------------------------------------------------------------------
# the WKV kernels: rwkv6's recurrence as one op
# --------------------------------------------------------------------------
def _wkv_inputs(torch, gen, dev, b, s, dt, kp):
    """r, k, v in ``dt``, a decay w = exp(-exp(w0 + noise)) about rwkv6's
    w0 = -2, u and a nonzero state at ``WKV_HEADS`` heads of K' ``kp`` x
    V ``WKV_HD``."""
    h, hd = WKV_HEADS, WKV_HD

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    r, k = (rnd(b, s, h, kp).to(dt) for _ in range(2))
    v = rnd(b, s, h, hd).to(dt)
    w = torch.exp(-torch.exp(-2.0 + rnd(b, s, h, kp, scale=0.5)))
    return r, k, v, w, rnd(h, kp, scale=0.1), rnd(b, h, kp, hd, scale=0.1)


def phase_wkv(ctx) -> dict:
    """The WKV kernels against ``wkv6_ref`` / ``wkv6_bwd_ref`` on the card
    at ``WKV_CASES``, every output under the fp32 rule of rows 1-7
    (``_within``), two launches on the same inputs in the same bits;
    then each timed (``Timer``: CUDA events around a captured graph)
    beside the plain version, the bound (bytes: each input the function
    reads once, each output once; ``WKV_FWD_OPS`` / ``WKV_BWD_OPS``
    fp32 operations a (b, t, h, k, j)) and the serial floor (S x ``WKV_STEP_FLOOR_S``).  No PyTorch
    call computes the recurrence: ``library_ms`` is None."""
    from repro_torch.kernels import wkv as WKV
    from repro_torch.kernels.ref import wkv6_bwd_ref, wkv6_ref
    torch, dev, timer, bw = (ctx["torch"], ctx["device"], ctx["timer"],
                             ctx["bandwidth"])
    gen = torch.Generator(device=dev).manual_seed(ctx["seed"] + 17)
    rows = {}
    for label, b, s, dname, backward, kp in WKV_CASES:
        dt = torch.bfloat16 if dname == "bf16" else torch.float32
        ins = _wkv_inputs(torch, gen, dev, b, s, dt, kp)
        if backward:
            kernel = "wkv6_bwd"
            ckpt = WKV.wkv6_cuda(*ins, WKV.CHUNK)[2]
            gy = torch.randn((b, s, WKV_HEADS, WKV_HD), generator=gen,
                             device=dev)
            gs = torch.randn(ins[5].shape, generator=gen, device=dev)

            def run(ins=ins, ckpt=ckpt, gy=gy, gs=gs):
                return WKV.wkv6_bwd_cuda(*ins[:5], ckpt, gy, gs)

            def plain(ins=ins, gy=gy, gs=gs):
                return wkv6_bwd_ref(*ins, gy, gs)

            names = ("dr", "dk", "dv", "dw", "du", "d_state0")
            read = list(ins[:5]) + [ckpt, gy, gs]   # not the initial state
            ops = WKV_BWD_OPS
        else:
            kernel = "wkv6"

            def run(ins=ins):
                return WKV.wkv6_cuda(*ins)[:2]

            def plain(ins=ins):
                return wkv6_ref(*ins)

            names, read, ops = ("y", "state"), list(ins), WKV_FWD_OPS
        got, again, want = run(), run(), plain()
        errs = {}
        for name, g, a, w in zip(names, got, again, want):
            ok, errs[name] = _within(kernel, "fp32", g, w)
            need(ok, f"[wkv] {kernel} {label} {name}: max|kernel-plain| "
                 f"{errs[name]:.3e} > {KERNEL_REL_TOL} * "
                 f"{float(w.float().abs().max()):.3e} + {KERNEL_ABS_TOL}")
            need(torch.equal(g, a), f"[wkv] {kernel} {label} {name}: two "
                 "launches on the same inputs gave different bits")
        split = label in WKV_SPLIT_CASES and wkv_split_bits(WKV, ins, got)
        need(split or label not in WKV_SPLIT_CASES,
             f"[wkv] {kernel} {label}: two launches over S/2 that carry the "
             "state differ in bits from one over S")
        t_k = timer(run, per_graph=WKV_PER_GRAPH)
        t_1 = timer(run)
        t_p = timer(plain, reps=3)
        nbytes = sum(t.numel() * t.element_size() for t in read + list(got))
        flops = ops * b * s * WKV_HEADS * kp * WKV_HD
        t_bytes, t_ops = nbytes / bw * 1e3, flops / PEAKS["fp32"] * 1e3
        r = {"kernel": kernel, "variant": label, "B": b, "S": s,
             "H": WKV_HEADS, "K": kp, "hd": WKV_HD, "dtype": dname,
             "max_abs_err": max(errs.values()), "errors": errs, "ms": t_k,
             "plain_ms": t_p, "library_ms": None,
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "share_of_bound": max(t_bytes, t_ops) / t_k,
             "serial_floor_ms": s * WKV_STEP_FLOOR_S * 1e3,
             "bytes": nbytes, "flops": flops,
             "us_per_step": t_k * 1e3 / s, "split_bits": split,
             "ms_one_per_graph": t_1}
        rows[label] = r
        log(f"[wkv] {kernel:8s} {label:9s} B {b} x S {s} x H {WKV_HEADS} x "
            f"K' {kp} x V {WKV_HD} {dname}: max|kernel-plain| "
            f"{r['max_abs_err']:.2e}, bits repeat"
            f"{', S/2 + S/2 in bits' if split else ''}; {t_k * 1e3:8.1f} us "
            f"({t_1 * 1e3:.1f} one launch a graph; {r['us_per_step']:.2f} "
            f"us a step; plain {t_p * 1e3:9.1f} us, "
            f"bound {r['bound_ms'] * 1e3:6.2f} us by {r['bound_by']}, "
            f"{100 * r['share_of_bound']:.1f}% of it; serial floor "
            f"{r['serial_floor_ms'] * 1e3:5.2f} us)")
    ctx["report"]["wkv_instances"] = wkv_instances(ctx, WKV, wkv6_ref)
    ctx["report"]["wkv"] = rows
    return rows


def wkv_instances(ctx, WKV, wkv6_ref) -> dict:
    """Every forward instance on the card (``WKV_SWEEP``): ``y``, the
    final state and the checkpoint after ``CHUNK`` steps within the fp32
    rule of ``wkv6_ref`` (over S, and over the first ``CHUNK`` steps),
    the first checkpoint the initial state in bits -> {case: max error}."""
    torch, dev = ctx["torch"], ctx["device"]
    gen = torch.Generator(device=dev).manual_seed(ctx["seed"] + 19)
    b, s = WKV_SWEEP_BS
    errs, seen = {}, set()
    for dname, kp in WKV_SWEEP:
        dt = torch.bfloat16 if dname == "bf16" else torch.float32
        ins = _wkv_inputs(torch, gen, dev, b, s, dt, kp)
        y, st, ck = WKV.wkv6_cuda(*ins, WKV.CHUNK)
        want_y, want_s = wkv6_ref(*ins)
        want_c = wkv6_ref(*(t[:, :WKV.CHUNK] for t in ins[:4]), *ins[4:])[1]
        kg = WKV._plan(b, WKV_HEADS, kp, WKV_HD).kg
        seen.add((dname, kg))
        label = f"{dname} K' {kp} (KG {kg})"
        e = {}
        for name, g, w in (("y", y, want_y), ("state", st, want_s),
                           ("ckpt", ck[:, :, 1], want_c)):
            ok, e[name] = _within("wkv6", "fp32", g, w)
            need(ok, f"[wkv] instance {label} {name}: max|kernel-plain| "
                 f"{e[name]:.3e} > {KERNEL_REL_TOL} * "
                 f"{float(w.abs().max()):.3e} + {KERNEL_ABS_TOL}")
        need(torch.equal(ck[:, :, 0], ins[5]),
             f"[wkv] instance {label}: the first checkpoint is not the "
             "initial state")
        errs[label] = max(e.values())
    need(len(seen) == WKV_INSTANCES - 2,
         f"[wkv] the sweep ran {len(seen)} forward instances, want "
         f"{WKV_INSTANCES - 2}")
    log(f"[wkv] every forward instance within the fp32 rule at B {b} x S "
        f"{s}: " + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()))
    return errs


def wkv_split_bits(WKV, ins, got) -> bool:
    """The forward over S/2, then over the rest from the state it left,
    against one launch over S (``got``): ``y`` and the final state in the
    same bits (every sum's order is fixed by k and j alone)."""
    torch = sys.modules["torch"]
    r, k, v, w, u, st = ins
    h = r.shape[1] // 2
    ya, sa = WKV.wkv6_cuda(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u,
                           st)[:2]
    yb, sb = WKV.wkv6_cuda(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u,
                           sa)[:2]
    return (torch.equal(torch.cat([ya, yb], 1), got[0])
            and torch.equal(sb, got[1]))


def wkv_entries(rows: dict, launches: dict) -> list:
    """The kernels line's WKV entries: ``WKV_MAIN``'s case of each, with
    the main path's launches (the families phase's rwkv6 serve for the
    forward, train check (e)'s rwkv6 step for the backward)."""
    return [_entry(k, launches[k], rows[v]["max_abs_err"], rows[v])
            for k, v in WKV_MAIN.items()]


def _leaves(tree: dict):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# --------------------------------------------------------------------------
# autotune: the schedule space, the search and the plan cache on the card
# --------------------------------------------------------------------------
def autotune_no_pin(ctx) -> dict:
    """(g) the phase runs the kernels only without a ``ref`` pin, and the
    provenance names backend and impl ``cuda``."""
    from repro_torch.kernels import ops
    pin = os.environ.get(ops.ENV_IMPL, "").strip()
    need(pin in ("", "cuda"), f"[autotune] {ops.ENV_IMPL}={pin!r} would hide "
         "every kernel; unset it (or set cuda)")
    prov = ops.provenance()
    need(prov["backend"] == "cuda" and prov["impl"] == "cuda",
         f"[autotune] provenance {prov}")
    log(f"[autotune:provenance] {json.dumps(prov)}")
    return prov


def autotune_gate_pack(ctx, params):
    """Layer 0's w_gate (d_ff x d_model) pruned to ``PROJ_SPARSITY`` and
    packed as plain ELL, as the reference's serving example tunes it."""
    from repro_torch.core.pruning import magnitude_prune
    from repro_torch.core.sparse_format import pack_ell
    t0 = time.perf_counter()
    w = magnitude_prune(
        params["layers"]["mlp"]["w_gate"][0].float().cpu().numpy().T,
        PROJ_SPARSITY)
    pack = pack_ell(w)
    log(f"[autotune] layer-0 w_gate {w.shape[0]}x{w.shape[1]} at "
        f"{PROJ_SPARSITY:.0%} sparsity packed in "
        f"{time.perf_counter() - t0:.1f} s")
    return pack


def _unscatter(torch, y, perm, n_rows):
    out = torch.zeros((n_rows,) + tuple(y.shape[1:]), dtype=y.dtype,
                      device=y.device)
    keep = perm >= 0
    out[perm[keep].long()] = y[keep]
    return out


def _gate_planes(ctx, cp) -> dict:
    """The chunked gate pack's planes on the card for kernel 1 (fp32 and
    bf16 values) and kernel 2 (int8 and nibble-packed int4 codes), each
    integer-valued (sign(w) * (1 + column % 7) for the matrix's global
    column, so every chunk width holds the same matrix and every sum is
    exact in fp32) and real-valued (the weights; the codes stay
    integers)."""
    torch, dev = ctx["torch"], ctx["device"]
    cols = torch.tensor(cp.cols, dtype=torch.int32, device=dev)
    vals = torch.tensor(cp.values, dtype=torch.float32, device=dev)
    k = torch.arange(cols.shape[1], device=dev).view(1, -1, 1)
    vint = torch.sign(vals) * (1 + (cols + k * cp.chunk_cols) % 7).float()
    q8 = vint.to(torch.int8)
    return {"cols": cols, "perm": torch.tensor(cp.perm, device=dev),
            "int": {"fp32": vint, "bf16": vint.to(torch.bfloat16),
                    "int8": q8, "int4": _nibble_pack(torch, q8)},
            "real": {"fp32": vals, "bf16": vals.to(torch.bfloat16),
                     "int8": q8, "int4": _nibble_pack(torch, q8)}}


def _gate_launch(ops, planes, kind, variant, x, cc, impl, schedule=None):
    v = planes[kind][variant]
    if variant in ("fp32", "bf16"):
        return ops.espim_spmv_batched(v, planes["cols"], x, chunk_cols=cc,
                                      impl=impl, schedule=schedule)
    return ops.espim_spmv_batched_quant(v, planes["cols"], None, x,
                                        chunk_cols=cc, impl=impl,
                                        schedule=schedule)


def autotune_schedules(ctx, pack) -> tuple[dict, dict]:
    """(a) every legal schedule of kernels 1-2 on the gate pack, at every
    chunk width, B in ``AUTOTUNE_BATCHES``: on integer-valued planes and x
    its output, unscattered, has the bits of the default schedule's and of
    the plain version's; on real values it is within the kernels'
    tolerance of the plain version.  Returns the report and the chunked
    packs by width."""
    from repro_torch.core.sdds import DEFAULT_SCHEDULE, enumerate_schedules
    from repro_torch.core.sparse_format import chunk_pack
    from repro_torch.kernels import ops
    torch, dev = ctx["torch"], ctx["device"]
    gen = torch.Generator(device=dev).manual_seed(ctx["seed"] + 9)
    xs = {("int", b): torch.randint(-3, 4, (pack.n_cols, b), generator=gen,
                                    device=dev).float()
          for b in AUTOTUNE_BATCHES}
    xs.update({("real", b): torch.randn((pack.n_cols, b), generator=gen,
                                        device=dev)
               for b in AUTOTUNE_BATCHES})
    scheds = enumerate_schedules(n_cols=pack.n_cols)
    need(scheds[0] == DEFAULT_SCHEDULE
         or DEFAULT_SCHEDULE.chunk_cols > pack.n_cols,
         "[autotune] the default schedule is not the first candidate")
    widths = list(dict.fromkeys(s.chunk_cols for s in scheds))
    chunked, base, worst, n_checks = {}, {}, {}, 0
    t_pack = 0.0
    for cc in widths:
        t0 = time.perf_counter()
        cp = chunked[cc] = chunk_pack(pack, cc)
        t_pack += time.perf_counter() - t0
        planes = _gate_planes(ctx, cp)
        for variant in ("fp32", "bf16", "int8", "int4"):
            for b in AUTOTUNE_BATCHES:
                for kind in ("int", "real"):
                    x = xs[(kind, b)]
                    plain = _gate_launch(ops, planes, kind, variant, x, cc,
                                         "ref")
                    tol = (KERNEL_REL_TOL * float(plain.abs().max())
                           + KERNEL_ABS_TOL)
                    un_plain = _unscatter(torch, plain, planes["perm"],
                                          pack.n_rows)
                    for s in scheds:
                        if s.chunk_cols != cc:
                            continue
                        got = _gate_launch(ops, planes, kind, variant, x, cc,
                                           None, s)
                        what = f"[autotune:a] {variant} {kind} B={b} {s}"
                        need(bool(torch.isfinite(got).all()), f"{what}: "
                             "non-finite output")
                        n_checks += 1
                        if kind == "int":
                            un = _unscatter(torch, got, planes["perm"],
                                            pack.n_rows)
                            base.setdefault((variant, b), un)
                            need(torch.equal(un, un_plain), f"{what}: bits "
                                 "differ from the plain version's")
                            need(torch.equal(un, base[(variant, b)]),
                                 f"{what}: bits differ from the default "
                                 "schedule's")
                            continue
                        err = float((got - plain).abs().max())
                        need(err <= tol, f"{what}: max|kernel-plain| "
                             f"{err:.3e} > {tol:.3e}")
                        key = f"{variant} B={b}"
                        worst[key] = max(worst.get(key, 0.0), err)
    log(f"[autotune:a] {len(scheds)} legal schedules of kernels 1-2 over "
        f"chunk widths {widths} (chunk pass {t_pack:.1f} s): {n_checks} "
        "launches; every integer-valued one bit-identical to the default "
        "schedule and the plain version; every real-valued one within "
        f"{KERNEL_REL_TOL}*max|plain| + {KERNEL_ABS_TOL} (worst "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + ")")
    return ({"schedules": len(scheds), "chunk_widths": widths,
             "launches": n_checks, "chunk_pass_s": t_pack,
             "worst_real_err": worst}, chunked)


def autotune_explicit_default(ctx, sparse8, sparse_fp) -> dict:
    """(b) ``schedule=KernelSchedule(512, 0, 2)`` gives the bits of
    ``schedule=None`` on every kernel 1-4 and 6 case of the kernels
    phase, at every ``CHECK_BATCHES`` B."""
    from repro_torch.core.sdds import KernelSchedule
    from repro_torch.kernels import ops
    torch, dev = ctx["torch"], ctx["device"]
    explicit = KernelSchedule(512, 0, 2)
    cases = kernel_cases(ctx, sparse8, sparse_fp)
    gen = torch.Generator(device=dev).manual_seed(ctx["seed"] + 2)
    xs = {(m, b): torch.randn((m, b), generator=gen, device=dev)
          for m in {c["m"] for c in cases} for b in CHECK_BATCHES}
    n = 0
    for c in cases:
        for b in CHECK_BATCHES:
            x = xs[(c["m"], b)]
            got = run_case(ops, c, x, None, schedule=explicit)
            want = run_case(ops, c, x, None)
            need(torch.equal(got, want),
                 f"[autotune:b] {c['kernel']} {c['variant']} "
                 f"{c['group']}/b{c['bucket']} B={b}: the explicit default "
                 "schedule's bits differ from schedule=None's")
            n += 1
    kernels = sorted({c["kernel"] for c in cases})
    log(f"[autotune:b] {explicit}: {n} cases of {', '.join(kernels)} "
        "bit-identical to schedule=None")
    return {"checks": n, "kernels": kernels}


def _timings(ctx, fn, flush) -> dict:
    """µs of ``fn`` by ``time_launch`` (best and p50 of its samples), by
    ``Timer`` (median), and by ``Timer`` with L2 cold: a graph of the
    L2-evicting read ``flush`` (``(read, its µs)``) and the launch, less
    the read, as ``bucket_times`` times a bucket."""
    from repro_torch.telemetry.profile import time_launch
    t = time_launch(fn, iters=5, warmup=1)
    need(t.clock == "device", f"[autotune] time_launch used the {t.clock} "
         "clock on a CUDA launch")
    read, read_us = flush
    return {"time_launch_best_us": t.best_us,
            "time_launch_p50_us": t.p50_us,
            "timer_us": ctx["timer"](fn) * 1e3,
            "timer_cold_us": ctx["timer"](lambda: (read(), fn())) * 1e3
            - read_us}


def autotune_search(ctx, pack, chunked) -> dict:
    """(c) ``autotune_pack`` on the gate pack, fp32 and int8, B in
    ``AUTOTUNE_BATCHES``, each with a fresh in-memory ``PlanCache``: the
    plan, the candidates timed, the winner's and the default's µs (by
    ``time_launch`` and by ``Timer``); then the same call again must be a
    cache hit with 0 benchmarks.  Returns the report and the caches."""
    from repro_torch.autotune import (PlanCache, autotune_pack,
                                      reset_search_stats, search_stats)
    from repro_torch.autotune.tuner import _launch_fn, _resolve_impl
    from repro_torch.core.sdds import DEFAULT_SCHEDULE
    from repro_torch.core.sparse_format import chunk_pack
    torch, dev = ctx["torch"], ctx["device"]
    impl = _resolve_impl(ctx["impl"], dev)
    buf = torch.ones(32 << 20, device=dev)      # 128 MB: evicts the 50 MB L2
    flush = (buf.sum, ctx["timer"](buf.sum) * 1e3)
    out, caches = {}, {}
    for quant in (None, "int8"):
        for b in AUTOTUNE_BATCHES:
            label = f"{quant or 'fp32'} B={b}"
            cache = caches[(quant, b)] = PlanCache()
            reset_search_stats()
            t0 = time.perf_counter()
            plan = autotune_pack(pack, b=b, quant=quant, cache=cache,
                                 max_candidates=AUTOTUNE_CANDIDATES,
                                 iters=5, warmup=1)
            search_s = time.perf_counter() - t0
            n_bench = search_stats["benchmarks"]
            need(plan.source == "search" and n_bench == plan.candidates > 0,
                 f"[autotune:c] {label}: {plan}")
            again = autotune_pack(pack, b=b, quant=quant, cache=cache,
                                  max_candidates=AUTOTUNE_CANDIDATES)
            need(again.source == "cache" and again.candidates == 0
                 and search_stats["benchmarks"] == n_bench
                 and again.schedule == plan.schedule,
                 f"[autotune:c] {label}: the second call was not a cache "
                 f"hit with 0 benchmarks ({again}, {search_stats})")
            x = torch.randn((pack.n_cols, b), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(
                                ctx["seed"] + 12))
            s_w = plan.schedule
            cc_d = DEFAULT_SCHEDULE.chunk_cols
            for cc in (s_w.chunk_cols, cc_d):
                if cc not in chunked:
                    chunked[cc] = chunk_pack(pack, cc)
            win = _timings(ctx, _launch_fn(chunked[s_w.chunk_cols], x, s_w,
                                             impl, quant), flush)
            dflt = _timings(ctx, _launch_fn(chunked[cc_d], x,
                                              DEFAULT_SCHEDULE, impl, quant),
                              flush)
            out[label] = {"plan": plan.to_provenance(),
                          "search_s": search_s, "winner": win,
                          "default": dflt}
            log(f"[autotune:c] {label}: plan chunk_cols={s_w.chunk_cols} "
                f"warps_per_row={s_w.warps_per_row} u={s_w.u} "
                f"({plan.candidates} candidates timed, search "
                f"{search_s:.1f} s, search best {plan.best_us:.1f} us); "
                f"winner {win['time_launch_best_us']:.1f} / "
                f"{win['time_launch_p50_us']:.1f} us (time_launch best / "
                f"p50), {win['timer_us']:.1f} us (Timer), "
                f"{win['timer_cold_us']:.1f} us (Timer, L2 cold); default "
                f"{dflt['time_launch_best_us']:.1f} / "
                f"{dflt['time_launch_p50_us']:.1f} us, "
                f"{dflt['timer_us']:.1f} us, {dflt['timer_cold_us']:.1f} "
                "us; second call: cache hit, 0 benchmarks")
    reset_search_stats()
    return out, caches


def autotune_buckets(ctx, sparse8, sparse_fp) -> dict:
    """(d) each bucket of layer 0 of the int8 engine packs at B = 4 over
    its legal schedules (chunked packs: warps a row and u, the ring's
    stages in flight, move; the gate+up buckets run the GLU kernel, u = 2
    only), timed by
    ``time_launch``: default against best µs a bucket, and their sums."""
    from repro_torch.core.sdds import (KernelSchedule, enumerate_schedules,
                                       fill_warps_per_row)
    from repro_torch.kernels import ops
    from repro_torch.telemetry.profile import time_launch
    torch, dev = ctx["torch"], ctx["device"]
    cases = [c for c in kernel_cases(ctx, sparse8, sparse_fp)
             if c["layer"] == 0 and c["variant"] == "int8"]
    gen = torch.Generator(device=dev).manual_seed(ctx["seed"] + 10)
    xs = {m: torch.randn((m, 4), generator=gen, device=dev)
          for m in {c["m"] for c in cases}}
    rows, sum_d, sum_b = [], 0.0, 0.0
    for c in cases:
        glu = "glu" in c["kernel"]
        cc = c["cc"]
        scheds = [s for s in enumerate_schedules(
            n_cols=c["m"], epilogue="glu" if glu else None,
            chunk_cols_options=(cc,)) if s.chunk_cols == cc]
        default = KernelSchedule(cc, 0, 2)
        fill = fill_warps_per_row(c["cols"].shape[1] * c["cols"].shape[2])
        # an explicit warps a row equal to the default's launches what 0
        # does: time each launch once
        scheds = [default] + [s for s in scheds if s != default
                              and s.warps_per_row != fill]
        times = {}
        for s in scheds:
            t = time_launch(lambda s=s: run_case(ops, c, xs[c["m"]], None,
                                                 schedule=s),
                            iters=5, warmup=1)
            times[(s.warps_per_row, s.u)] = t.best_us
        d_us = times[(0, 2)]
        (bw, bu), b_us = min(times.items(), key=lambda kv: kv[1])
        sum_d += d_us
        sum_b += b_us
        r, k, lc = c["cols"].shape
        rows.append({"kernel": c["kernel"], "group": c["group"],
                     "bucket": c["bucket"], "rows": r, "K": k, "Lc": lc,
                     "fill_wpr": fill, "default_us": d_us, "best_us": b_us,
                     "best": {"warps_per_row": bw, "u": bu},
                     "us": {f"{w},{u}": t for (w, u), t in times.items()}})
        log(f"[autotune:d] {c['kernel']:28s} {c['group']:8s}/b{c['bucket']} "
            f"rows {r:5d} K {k:2d} Lc {lc:3d}: default (fill {fill}, u 2) "
            f"{d_us:6.1f} us, best (wpr {bw}, u {bu}) {b_us:6.1f} us "
            f"({b_us / d_us:.3f}x) of {len(times)} schedules")
    log(f"[autotune:d] layer 0, B=4: sum of defaults {sum_d:.1f} us, sum of "
        f"bests {sum_b:.1f} us ({sum_b / sum_d:.3f}x)")
    return {"buckets": rows, "default_sum_us": sum_d, "best_sum_us": sum_b}


def autotune_pack_matvec(ctx, pack, caches) -> dict:
    """(e) ``pack_to_device(autotune=True)`` attaches the plan (from the
    search's warm cache), and ``espim_matvec`` on the tuned weights, at
    a 1-D and a (n_in, 4) x, matches ``impl="ref"``."""
    from repro_torch.autotune import TunedPlan
    from repro_torch.kernels import ops
    torch, dev = ctx["torch"], ctx["device"]
    gen = torch.Generator(device=dev).manual_seed(ctx["seed"] + 11)
    x = torch.randn((pack.n_cols, 4), generator=gen, device=dev)
    out = {}
    for quant in (None, "int8"):
        w = ops.pack_to_device(pack, quant=quant, autotune=True,
                               tune={"b": 4, "cache": caches[(quant, 4)]})
        plan = w.schedule
        need(isinstance(plan, TunedPlan) and plan.source == "cache"
             and w.chunk_cols == plan.schedule.chunk_cols,
             f"[autotune:e] {quant}: plan {plan}, chunk_cols {w.chunk_cols}")
        errs = []
        for xx in (x[:, 0], x):
            got = ops.espim_matvec(w, xx)
            want = ops.espim_matvec(w, xx, impl="ref")
            err = float((got - want).abs().max())
            tol = KERNEL_REL_TOL * float(want.abs().max()) + KERNEL_ABS_TOL
            need(got.shape == want.shape and err <= tol,
                 f"[autotune:e] {quant} x{tuple(xx.shape)}: max|kernel-ref| "
                 f"{err:.3e} > {tol:.3e}")
            errs.append(err)
        out[quant or "fp32"] = {"plan": plan.to_provenance(),
                                "max_abs_err": errs}
        log(f"[autotune:e] pack_to_device(autotune=True, quant={quant}): "
            f"plan {plan.schedule} from the {plan.source}; espim_matvec "
            f"1-D / B=4 within tolerance of impl='ref' (max err "
            f"{errs[0]:.2e} / {errs[1]:.2e})")
    return out


def autotune_example(ctx) -> dict:
    """(f) ``examples/serve_sparse_llm_torch.py --autotune`` at its
    reduced config, as a subprocess."""
    cmd = [sys.executable, str(EXAMPLE), "--autotune", *EXAMPLE_ARGS]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=EXAMPLE_TIMEOUT_S,
                              env=dict(os.environ, PYTHONPATH=str(SRC)))
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"[autotune:f] the example ran past "
                           f"{EXAMPLE_TIMEOUT_S} s") from None
    wall = time.perf_counter() - t0
    need(proc.returncode == 0, f"[autotune:f] exit {proc.returncode}: "
         f"{proc.stderr.strip()[-2000:]}")
    hit = re.search(r"re-tuned: source=cache \(0 benchmarks", proc.stdout)
    eq = re.search(r"(\d+)/(\d+) greedy tokens equal", proc.stdout)
    tune = re.search(r"searched: (.*)", proc.stdout)
    served = re.search(r"autotuned engine (.*)", proc.stdout)
    need(bool(hit and eq and tune and served),
         f"[autotune:f] the example's output lacks its autotune lines: "
         f"{proc.stdout[-2000:]!r}")
    log(f"[autotune:f] {EXAMPLE.relative_to(ROOT)} --autotune: "
        f"{tune.group(1)}; re-tuned from the cache with 0 benchmarks; "
        f"{served.group(1)} ({wall:.1f} s with the process start)")
    return {"wall_s": wall, "searched": tune.group(1),
            "served": served.group(1), "tokens_equal": int(eq.group(1)),
            "tokens": int(eq.group(2))}


def phase_autotune(ctx, params, sparse8, sparse_fp) -> dict:
    """The schedule space, the search and the plan cache on the card, (a)
    to (g); after every other phase's counter reads (a launch captured in
    a timing graph counts once, at capture)."""
    t0 = time.perf_counter()
    rep = {"provenance": autotune_no_pin(ctx)}
    pack = autotune_gate_pack(ctx, params)
    rep["schedules"], chunked = autotune_schedules(ctx, pack)
    rep["explicit_default"] = autotune_explicit_default(ctx, sparse8,
                                                        sparse_fp)
    rep["search"], caches = autotune_search(ctx, pack, chunked)
    rep["buckets"] = autotune_buckets(ctx, sparse8, sparse_fp)
    rep["pack"] = autotune_pack_matvec(ctx, pack, caches)
    rep["example"] = autotune_example(ctx)
    rep["seconds"] = time.perf_counter() - t0
    log(f"[autotune] phase {rep['seconds']:.1f} s")
    ctx["report"]["autotune"] = rep
    return rep


def _tree_rel(got: dict, want: dict) -> tuple[float, str]:
    """max over leaves of max|got - want| / max|want| (want on the CPU)
    -> (worst, its leaf)."""
    from repro_torch.sharding.partition import full_value
    from repro_torch.tree import flatten
    worst, name = 0.0, ""
    for (k, a), (_, b) in zip(flatten(got), flatten(want)):
        a, b = full_value(a).float().cpu(), full_value(b).float().cpu()
        err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        if err > worst:
            worst, name = err, k
    return worst, name


def _tree_equal(got: dict, want: dict) -> list:
    """The leaves whose bits differ."""
    from repro_torch.sharding.partition import full_value
    from repro_torch.tree import flatten
    return [k for (k, a), (_, b) in zip(flatten(got), flatten(want))
            if not full_value(a).equal(full_value(b))]


def _rel(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def train_dispatch(ctx) -> dict:
    """(g) ``layers.flash_attention`` at phi3.5's attention shape in bf16:
    under no_grad kernel 8 launches once (and agrees with the chunked
    softmax within the bf16 tolerance); under grad it does not launch,
    and the q / k / v gradients equal the chunked path's bits."""
    from repro_torch.models import layers as L
    torch, dev = ctx["torch"], ctx["device"]
    b, s, h, kv, hd = TRAIN_FLASH_SHAPE
    gen = torch.Generator(device=dev).manual_seed(ctx["seed"] + 21)
    q, k, v = (torch.randn((b, s, n, hd), generator=gen, device=dev
                           ).to(torch.bfloat16) for n in (h, kv, kv))
    reset_launches()
    with torch.no_grad():
        fwd = L.flash_attention(q, k, v, causal=True)
    no_grad = read_launches()["flash_attention"]
    need(no_grad == 1, f"[train:g] kernel 8 launched {no_grad} times "
         "under no_grad, not once")
    with torch.no_grad():
        chunked = L._flash_chunked(q, L.repeat_kv(k, h // kv),
                                   L.repeat_kv(v, h // kv), True, 512, 1024)
    ok, err = _within("flash_attention", "bf16", fwd, chunked)
    need(ok, f"[train:g] kernel 8 against the chunked softmax: {err:.3e}")
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    w = torch.randn((b, s, h, hd), generator=gen, device=dev)
    reset_launches()
    out = L.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad((out.float() * w).sum(), leaves)
    under_grad = read_launches()["flash_attention"]
    need(under_grad == 0, f"[train:g] kernel 8 launched {under_grad} times "
         "under grad")
    ref_leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    ref = L._flash_chunked(ref_leaves[0],
                           L.repeat_kv(ref_leaves[1], h // kv),
                           L.repeat_kv(ref_leaves[2], h // kv), True, 512,
                           1024)
    want = torch.autograd.grad((ref.float() * w).sum(), ref_leaves)
    same = [bool(a.equal(b_)) for a, b_ in zip(grads, want)]
    need(all(same), f"[train:g] q/k/v grads equal to the chunked path's: "
         f"{same}")
    return {"shape": TRAIN_FLASH_SHAPE, "launches_no_grad": no_grad,
            "launches_grad": under_grad, "fwd_vs_chunked_max_abs": err,
            "grads_equal": same}


def train_full_width(ctx, mesh) -> dict:
    """(a) ``Trainer`` on granite-3-2b at its whole depth and width (bf16
    params, float32 master, remat "full") on the (1, 1) mesh: finite loss
    and grad norm, kernel 8 never launched, the step's time, tokens/s,
    peak memory and share of the bf16 peak."""
    import tempfile

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves
    torch = ctx["torch"]
    cfg = get_config(TRAIN_ARCH)
    need(cfg.remat == "full" and cfg.param_dtype == "bfloat16",
         f"[train:a] {cfg.name} is {cfg.param_dtype}, remat {cfg.remat}")
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(cfg, shape, mesh, OptConfig(),
                     TrainerConfig(ckpt_dir=d, ckpt_every=TRAIN_STEPS + 1,
                                   log_every=TRAIN_STEPS + 1,
                                   seed=ctx["seed"]))
        need(tr.init_or_resume() == ("fresh", 0), "[train:a] not fresh")
        n_params = sum(t.numel() for t in leaves(tr.state["params"]))
        state_bytes = sum(t.numel() * t.element_size()
                          for t in leaves(tr.state))
        state_gb = state_bytes / 1e9
        log(f"[train:a] {cfg.name}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, GQA {cfg.n_heads}/{cfg.n_kv_heads}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}; {n_params / 1e9:.3f} B "
            f"params, state {state_gb:.1f} GB (bf16 params, float32 "
            f"master, mu, nu)")
        reset_launches()
        secs, losses, gnorms = [], [], []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.train(1, log=None)
            losses.append(float(m["loss"]))     # synchronises
            secs.append(time.perf_counter() - t0)
            gnorms.append(float(m["grad_norm"]))
        launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        split = train_split(ctx, tr)
        prof = device_profile(torch, lambda: tr.train(1, log=None), 1)
        del tr, m
    torch.cuda.empty_cache()
    need(all(math.isfinite(x) for x in losses + gnorms),
         f"[train:a] loss {losses}, grad norm {gnorms}")
    need(launches["flash_attention"] == 0,
         f"[train:a] kernel 8 launched {launches['flash_attention']} times "
         "under grad")
    step_s = statistics.median(secs[1:])
    tokens = TRAIN_SEQ * TRAIN_BATCH
    # full remat: forward 2N, its recompute 2N, backward 4N a token; the
    # chunked attention's QK^T and PV over every (q, kv) block, 4 B S^2 H
    # hd a layer forward, four times over
    attn = (16 * TRAIN_BATCH * TRAIN_SEQ ** 2 * cfg.n_heads * cfg.hd
            * cfg.n_layers)
    flops = 8 * n_params * tokens + attn
    share = flops / step_s / PEAKS["bf16_tensor"]
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "state_bytes": state_bytes, "state_gb": state_gb,
           "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
           "step_s": secs, "step_ms_median_2_4": step_s * 1e3,
           "tokens_per_s": tokens / step_s, "peak_gb": peak_gb,
           "flops_per_step": flops, "attention_flops": attn,
           "share_of_bf16_peak": share, "loss": losses,
           "grad_norm": gnorms, "launches": launches, "split_ms": split,
           "device_ms": prof["busy_us"] / 1e3,
           "device_busy_share": prof["busy_us"] / 1e3 / prof["wall_ms"],
           "kernels": prof["kernels"], "top_kernels": prof["top"]}
    log(f"[train:a] {TRAIN_STEPS} steps at B {TRAIN_BATCH} x S "
        f"{TRAIN_SEQ}: loss {', '.join(f'{x:.4f}' for x in losses)}; grad "
        f"norm {', '.join(f'{x:.3f}' for x in gnorms)}; step ms "
        f"{', '.join(f'{x * 1e3:.1f}' for x in secs)} (median of 2-"
        f"{TRAIN_STEPS} {step_s * 1e3:.1f}; before the sharded path "
        f"{' and '.join(f'{x:.1f}' for x in GATHERED_TRAIN_STEP_MS)}), "
        f"{tokens / step_s:.0f} tokens/s, "
        f"peak {peak_gb:.2f} GB; {flops / 1e12:.2f} TFLOP a step (8 N "
        f"tokens + attention {attn / 1e12:.3f}) = {share:.4f} of "
        f"{PEAKS['bf16_tensor'] / 1e12:.0f} TFLOP/s; kernel 8 launches "
        f"{launches['flash_attention']}")
    log(f"[train:a] where a step goes: loss + autograd "
        f"{split['grads_ms']:.1f} ms, AdamW {split['adamw_ms']:.1f} ms (host "
        f"clock, synchronised); one profiled step: device busy "
        f"{rec['device_ms']:.1f} ms of {prof['wall_ms']:.1f} "
        f"({rec['device_busy_share']:.3f}), {prof['kernels']} kernels")
    for k in prof["top"]:
        log(f"[train:a]   {k['us_per_step'] / 1e3:8.2f} ms in "
            f"{k['per_step']:g} launches: {k['name']}")
    return rec


def train_split(ctx, tr) -> dict:
    """One more step of trainer ``tr``, its two halves timed apart on the
    host clock, each synchronised: the loss and its gradients (forward,
    recompute, backward), then the AdamW update."""
    from repro_torch.optim.adamw import apply_updates
    from repro_torch.sharding.partition import full_value
    from repro_torch.train import train_step as ts
    from repro_torch.tree import tree_map
    torch = ctx["torch"]
    state = tree_map(full_value, tr.state)
    batch = tr.pipe.batch_at(tr.step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, grads = ts._grads(tr.cfg, state["params"], batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    apply_updates(tr.ocfg, state["params"], grads, state["opt"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tr.step += 1
    return {"grads_ms": (t1 - t0) * 1e3, "adamw_ms": (t2 - t1) * 1e3}


def _check_state(ctx, seed: int, compress: bool = False) -> dict:
    """The checks' train state: granite at full width, 2 layers, float32,
    on the CPU from ``seed``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import train_step as ts
    torch = ctx["torch"]
    cfg = get_config(TRAIN_ARCH).replace(
        n_layers=TRAIN_CHECK_LAYERS, param_dtype="float32",
        compute_dtype="float32")
    return ts.init_train_state(cfg, OptConfig(),
                               torch.Generator().manual_seed(seed),
                               compress_grads=compress, device="cpu")


def train_checks(ctx, mesh) -> dict:
    """(b) one ``train_step_fn`` on the card against the CPU; (d)
    microbatches 2 against 1 on the card, and compressed grads for 3
    steps; (e) ``make_train_step`` on the (1, 1) mesh against
    ``train_step_fn`` in bits, ``espim_matvec_sharded`` (kernel 5 once)
    against ``ESPIMLinear``, ``make_serve_step`` against ``decode_step``
    in bits.  Granite at full width, 2 of 40 layers, float32, batch 2 x
    32."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.espim_linear import (ESPIMLinear,
                                               espim_matvec_sharded,
                                               make_sharded_weights)
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models import factory
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.serve.serve_step import make_serve_step
    from repro_torch.sharding import partition
    from repro_torch.train import train_step as ts
    from repro_torch.tree import tree_map
    torch, dev = ctx["torch"], ctx["device"]
    cfg = get_config(TRAIN_ARCH).replace(
        n_layers=TRAIN_CHECK_LAYERS, param_dtype="float32",
        compute_dtype="float32")
    ocfg = OptConfig()
    shape = ShapeConfig("check", TRAIN_CHECK_SEQ, TRAIN_CHECK_BATCH, "train")
    pipe = SyntheticPipeline.for_model(cfg, shape, seed=ctx["seed"],
                                       device="cpu")
    batch = pipe.batch_at(0)
    gbatch = tree_map(lambda t: t.to(dev), batch)
    seed = ctx["seed"] + 31

    def on_card(compress=False):
        return tree_map(lambda t: t.to(dev), _check_state(ctx, seed,
                                                          compress))

    rec = {}
    # (b)
    t0 = time.perf_counter()
    cpu = _check_state(ctx, seed)
    cpu, m_cpu = ts.train_step_fn(cfg, ocfg, cpu, batch)
    cpu_s = time.perf_counter() - t0
    card, m_card = ts.train_step_fn(cfg, ocfg, on_card(), gbatch)
    worst, leaf = _tree_rel(card, cpu)
    b = {"loss_rel": _rel(m_card["loss"], m_cpu["loss"]),
         "grad_norm_rel": _rel(m_card["grad_norm"], m_cpu["grad_norm"]),
         "leaf_rel": worst, "worst_leaf": leaf, "cpu_s": cpu_s,
         "loss": float(m_cpu["loss"]), "grad_norm": float(m_cpu["grad_norm"])}
    need(max(b["loss_rel"], b["grad_norm_rel"], worst) <= TRAIN_REL_TOL,
         f"[train:b] card vs CPU: {b}")
    rec["card_vs_cpu"] = b
    log(f"[train:b] train_step_fn at {cfg.n_layers} of 40 layers, full "
        f"width, float32, B {TRAIN_CHECK_BATCH} x S {TRAIN_CHECK_SEQ}: card "
        f"vs CPU loss {b['loss_rel']:.2e}, grad norm "
        f"{b['grad_norm_rel']:.2e}, worst state leaf {worst:.2e} ({leaf}) "
        f"(<= {TRAIN_REL_TOL}); CPU step {cpu_s:.1f} s")
    del cpu
    # (d)
    mb, m_mb = ts.train_step_fn(cfg, ocfg, on_card(), gbatch,
                                microbatches=2)
    worst, leaf = _tree_rel(mb, card)
    d = {"loss_rel": _rel(m_mb["loss"], m_card["loss"]),
         "grad_norm_rel": _rel(m_mb["grad_norm"], m_card["grad_norm"]),
         "leaf_rel": worst, "worst_leaf": leaf}
    need(max(d["loss_rel"], d["grad_norm_rel"], worst) <= TRAIN_REL_TOL,
         f"[train:d] microbatches 2 vs 1: {d}")
    del mb
    comp, losses = on_card(compress=True), []
    for i in range(TRAIN_COMPRESS_STEPS):
        comp, m = ts.train_step_fn(cfg, ocfg, comp,
                                   tree_map(lambda t: t.to(dev),
                                            pipe.batch_at(i)),
                                   compress_grads=True)
        losses.append(float(m["loss"]))
    need(all(math.isfinite(x) for x in losses),
         f"[train:d] compressed losses {losses}")
    d["compressed_losses"] = losses
    rec["microbatches"] = d
    del comp
    log(f"[train:d] microbatches 2 vs 1: loss {d['loss_rel']:.2e}, grad "
        f"norm {d['grad_norm_rel']:.2e}, worst leaf {worst:.2e} ({leaf}); "
        f"compress_grads {TRAIN_COMPRESS_STEPS} steps: loss "
        f"{', '.join(f'{x:.4f}' for x in losses)}")
    # (e) the train step through the mesh
    step, pspecs, bspecs = ts.make_train_step(
        cfg, ocfg, mesh, ts.init_train_state(cfg, ocfg, device="meta"),
        batch)
    placed = partition.logical_to_sharding(on_card(), pspecs, mesh)
    placed, m_mesh = step(placed, partition.logical_to_sharding(
        batch, bspecs, mesh))
    differ = _tree_equal(placed, card)
    need(not differ and bool(m_mesh["loss"].equal(m_card["loss"])),
         f"[train:e] mesh step vs train_step_fn: leaves differ {differ[:5]}")
    params = tree_map(partition.full_value, placed["params"])
    del placed, card
    torch.cuda.empty_cache()
    # (e) the sharded matvec: kernel 5 once
    w = params["layers"]["mlp"]["w_down"][0].T.cpu().numpy()
    sh = make_sharded_weights(w, 1, prune_sparsity=TRAIN_MATVEC_SPARSITY)
    x = torch.randn(w.shape[1], generator=torch.Generator(device=dev
                                                          ).manual_seed(seed),
                    device=dev)
    reset_launches()
    y = espim_matvec_sharded(sh, x, mesh)
    mv_launches = read_launches()
    lin = ESPIMLinear.from_dense(w, prune_sparsity=TRAIN_MATVEC_SPARSITY,
                                 device=dev)
    ok, mv_err = _within("espim_spmv", "fp32", y, lin(x))
    need(mv_launches["espim_spmv"] == 1 and sum(mv_launches.values()) == 1,
         f"[train:e] espim_matvec_sharded launches {mv_launches}")
    need(ok, f"[train:e] espim_matvec_sharded vs ESPIMLinear {mv_err:.3e}")
    # (e) the serve step through the mesh
    cache = factory.init_cache(cfg, TRAIN_CHECK_BATCH, 16, device=dev)
    sb = {"tokens": gbatch["tokens"][:, :1]}
    sstep, sp, cs, bs = make_serve_step(cfg, mesh, params, cache, sb)
    _, logits, new = sstep(partition.logical_to_sharding(params, sp, mesh),
                           partition.logical_to_sharding(cache, cs, mesh),
                           partition.logical_to_sharding(sb, bs, mesh))
    with torch.no_grad():
        want, want_cache = factory.decode_step(cfg, params, cache, sb)
    serve_differ = _tree_equal(new, want_cache)
    need(bool(logits.equal(want)) and not serve_differ,
         f"[train:e] make_serve_step vs decode_step: cache {serve_differ}")
    rec["mesh"] = {"train_step_bits_equal": True,
                   "matvec_launches": mv_launches, "matvec_max_abs": mv_err,
                   "matvec_shape": list(w.shape),
                   "serve_step_bits_equal": True}
    log(f"[train:e] (1, 1) mesh: make_train_step == train_step_fn in bits; "
        f"espim_matvec_sharded {tuple(w.shape)} at "
        f"{TRAIN_MATVEC_SPARSITY:.0%} sparsity: kernel 5 launches "
        f"{mv_launches['espim_spmv']}, vs ESPIMLinear {mv_err:.2e}; "
        f"make_serve_step == decode_step in bits")
    return rec


def _kernel8_per_forward(cfg) -> int:
    """Kernel 8's launches in one forward under no_grad: one a layer; for
    zamba2 one an application of the shared block; for whisper one an
    encoder layer and one a decoder layer's self-attention (its
    cross-attention has unequal lengths: the chunked softmax); none for
    rwkv6."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "audio":
        return cfg.encoder_layers + cfg.n_layers
    return 0 if cfg.family == "ssm" else cfg.n_layers


def _wkv_per_step(cfg) -> tuple[int, int]:
    """(WKV forward, WKV backward) launches of one train step: rwkv6's
    forward once a layer and again in the layer's recompute under remat,
    its backward once a layer; none for the other families."""
    n = wkv_expected(cfg)
    return n * (1 if cfg.remat == "none" else 2), n


def train_family_mesh(ctx, mesh) -> dict:
    """(e) for the other families' sharded paths on the (1, 1) mesh, each
    arch of ``TRAIN_FAMILY_MESH`` at its published widths in float32 (B 2
    x S 32; the VLM batch with M-RoPE positions and spliced patch
    embeddings, whisper's with frames, as the dry run's):
    ``make_train_step`` against ``train_step_fn`` (every state leaf, the
    loss and the aux loss), ``make_serve_step`` against ``decode_step``
    (logits and cache), and the sharded prefill forward
    (``factory.apply_train_sharded``) against ``apply_train`` at B 1 x S
    ``FAMILY_FLASH_SEQ`` under no_grad (whisper on seeded frames), all in
    bits, kernel 8 launched as often in the two forwards
    (``_kernel8_per_forward``); rwkv6's WKV kernels as often in each pair
    of steps (``_wkv_per_step``, ``wkv_expected``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import specs
    from repro_torch.models import factory, moe
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.serve.serve_step import make_serve_step
    from repro_torch.sharding import partition
    from repro_torch.train import train_step as ts
    from repro_torch.tree import leaves, tree_map
    torch, dev = ctx["torch"], ctx["device"]
    ocfg = OptConfig()
    shape = ShapeConfig("check", TRAIN_CHECK_SEQ, TRAIN_CHECK_BATCH, "train")
    seed = ctx["seed"] + 41
    rec = {}
    for arch, layers in TRAIN_FAMILY_MESH:
        cfg = get_config(arch).replace(param_dtype="float32",
                                       compute_dtype="float32")
        if layers:
            cfg = cfg.replace(n_layers=layers)
        need(factory.shards(cfg, mesh), f"[train:e] {arch} takes the "
             "gathered path")
        gen = torch.Generator(device=dev).manual_seed(seed)
        batch = {k: _batch_leaf(torch, k, t, cfg, gen, dev)
                 for k, t in specs.train_batch_specs(cfg, shape).items()}

        def state():
            return ts.init_train_state(
                cfg, ocfg, torch.Generator(device=dev).manual_seed(seed),
                device=dev)

        torch.cuda.empty_cache()
        reset_launches()
        card, m_card = ts.train_step_fn(cfg, ocfg, state(), batch)
        wkv = {"train_step_fn": read_launches()}
        state_gb = sum(t.numel() * t.element_size()
                       for t in leaves(card)) / 1e9
        step, pspecs, bspecs = ts.make_train_step(
            cfg, ocfg, mesh, ts.init_train_state(cfg, ocfg, device="meta"),
            batch)
        placed = partition.logical_to_sharding(state(), pspecs, mesh)
        reset_launches()
        placed, m_mesh = step(placed, partition.logical_to_sharding(
            batch, bspecs, mesh))
        wkv["make_train_step"] = read_launches()
        differ = _tree_equal(placed, card)
        same = [bool(m_mesh[k].equal(m_card[k])) for k in ("loss", "aux")]
        need(not differ and all(same), f"[train:e] {arch}: mesh step vs "
             f"train_step_fn: leaves differ {differ[:5]}, loss / aux equal "
             f"{same}")
        params = tree_map(partition.full_value, placed["params"])
        del placed, card
        torch.cuda.empty_cache()
        # the serve step through the mesh
        cache = factory.init_cache(cfg, TRAIN_CHECK_BATCH, 16, device=dev)
        sb = {"tokens": batch["tokens"][:, :1]}
        sstep, sp, cs, bs = make_serve_step(cfg, mesh, params, cache, sb)
        # the step donates its cache, which at one rank is ``cache``'s own
        # storage: the recurrent states would be read updated by
        # ``decode_step`` after it
        reset_launches()
        _, logits, new = sstep(
            partition.logical_to_sharding(params, sp, mesh),
            partition.logical_to_sharding(tree_map(torch.clone, cache), cs,
                                          mesh),
            partition.logical_to_sharding(sb, bs, mesh))
        wkv["make_serve_step"] = read_launches()
        reset_launches()
        with torch.no_grad():
            want, want_cache = factory.decode_step(cfg, params, cache, sb)
        wkv["decode_step"] = read_launches()
        serve_differ = _tree_equal(new, want_cache)
        need(bool(logits.equal(want)) and not serve_differ,
             f"[train:e] {arch}: make_serve_step vs decode_step: logits "
             f"equal {bool(logits.equal(want))}, cache {serve_differ}")
        # the prefill forward on the shards: kernel 8 once a layer
        toks = torch.randint(0, cfg.vocab_size, (1, FAMILY_FLASH_SEQ),
                             generator=gen, device=dev, dtype=torch.int32)
        pb = {"tokens": toks}
        if cfg.family == "audio":
            pb["frames"] = torch.randn((1, cfg.encoder_seq, cfg.d_model),
                                       generator=gen, device=dev)
        k8_want = _kernel8_per_forward(cfg)
        reset_launches()
        with torch.no_grad():
            want_l, want_aux = factory.apply_train(cfg, params, pb)
        wkv["apply_train"] = read_launches()
        k8_plain = wkv["apply_train"]["flash_attention"]
        pspec = partition.param_pspecs(params, mesh)
        placed_p = partition.logical_to_sharding(params, pspec, mesh)
        split = moe.Split(mesh, partition.batch_pspecs(pb, mesh)["tokens"][0])
        reset_launches()
        with torch.no_grad():
            got_l, got_aux = factory.apply_train_sharded(
                cfg, tree_map(lambda t: t.to_local(), placed_p), pb,
                partition.Layout.of(placed_p), split)
        wkv["apply_train_sharded"] = read_launches()
        k8 = wkv["apply_train_sharded"]["flash_attention"]
        fwd_same = bool(got_l.equal(want_l)) and bool(got_aux.equal(want_aux))
        need(fwd_same and k8 == k8_plain == k8_want,
             f"[train:e] {arch}: sharded prefill forward vs forward: equal "
             f"{fwd_same}, kernel 8 launches {k8} against {k8_plain}, "
             f"{k8_want} expected")
        fwd, bwd = _wkv_per_step(cfg)
        want_wkv = {"train_step_fn": (fwd, bwd), "make_train_step": (fwd, bwd),
                    **{k: (wkv_expected(cfg), 0) for k in (
                        "make_serve_step", "decode_step", "apply_train",
                        "apply_train_sharded")}}
        wkv = {k: (v["wkv6"], v["wkv6_bwd"]) for k, v in wkv.items()}
        need(wkv == want_wkv, f"[train:e] {arch}: WKV (forward, backward) "
             f"launches {wkv}, want {want_wkv}")
        rec[arch] = {"layers": cfg.n_layers, "state_gb": state_gb,
                     "loss": float(m_card["loss"]),
                     "aux": float(m_card["aux"]),
                     "train_step_bits_equal": True,
                     "serve_step_bits_equal": True,
                     "prefill_bits_equal": True,
                     "prefill_seq": FAMILY_FLASH_SEQ,
                     "kernel8_launches": [k8, k8_plain],
                     "wkv_launches": wkv}
        log(f"[train:e] {arch} at {cfg.n_layers} of "
            f"{get_config(arch).n_layers} layers, published widths, float32 "
            f"(state {state_gb:.1f} GB a copy): make_train_step == "
            f"train_step_fn in bits (loss {rec[arch]['loss']:.4f}, aux "
            f"{rec[arch]['aux']:.4f}); make_serve_step == decode_step in "
            f"bits; sharded prefill forward == forward in bits at S "
            f"{FAMILY_FLASH_SEQ}, kernel 8 launches {k8} and {k8_plain}"
            + (f"; WKV (forward, backward) launches {wkv}"
               if wkv_expected(cfg) else ""))
        del params, cache, new, want_cache, placed_p
        torch.cuda.empty_cache()
    return rec


def train_resume(ctx, mesh) -> dict:
    """(c) at 2 layers, full width, bf16: train 3, save, restore, train 2,
    against 5 straight; every state leaf and the last loss in bits, with
    deterministic algorithms on (embedding backward accumulates through
    ``index_put_``, which may use atomics otherwise)."""
    import tempfile

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    torch = ctx["torch"]
    cfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_CHECK_LAYERS)
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    ocfg = OptConfig(warmup_steps=2, decay_steps=100)

    def trainer(d):
        return Trainer(cfg, shape, mesh, ocfg,
                       TrainerConfig(ckpt_dir=d, ckpt_every=10 ** 9,
                                     log_every=10 ** 9, seed=ctx["seed"]))

    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as d1, \
                tempfile.TemporaryDirectory() as d2:
            tr = trainer(d1)
            tr.init_or_resume()
            tr.train(3, log=None)
            t0 = time.perf_counter()
            tr.save()
            save_s = time.perf_counter() - t0
            ckpt_gb = sum(f.stat().st_size
                          for f in Path(d1).rglob("*")) / 1e9
            del tr
            resumed = trainer(d1)
            t0 = time.perf_counter()
            kind = resumed.init_or_resume()
            restore_s = time.perf_counter() - t0
            m_r = resumed.train(2, log=None)
            straight = trainer(d2)
            straight.init_or_resume()
            m_s = straight.train(5, log=None)
            differ = _tree_equal(resumed.state, straight.state)
            same_loss = bool(m_r["loss"].equal(m_s["loss"]))
            del resumed, straight
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    need(kind == ("resumed", 3), f"[train:c] init_or_resume gave {kind}")
    need(not differ and same_loss,
         f"[train:c] resumed vs straight: leaves differ {differ[:5]}, last "
         f"loss equal {same_loss}")
    log(f"[train:c] resume at {cfg.n_layers} layers bf16: 3 + save + "
        f"restore + 2 == 5 straight in bits (every state leaf and the last "
        f"loss {float(m_s['loss']):.4f}); checkpoint {ckpt_gb:.2f} GB, save "
        f"{save_s:.1f} s, restore {restore_s:.1f} s")
    return {"bits_equal": True, "ckpt_gb": ckpt_gb, "save_s": save_s,
            "restore_s": restore_s, "last_loss": float(m_s["loss"])}


def train_launcher(ctx) -> dict:
    """(f) ``python -m repro_torch.launch.train --arch granite-3-2b
    --reduced`` as a subprocess for 10 steps into a temp checkpoint dir,
    then again with ``--steps 12``, which must resume at step 10."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for steps in TRAIN_LAUNCHER_STEPS:
            cmd = [sys.executable, "-m", "repro_torch.launch.train",
                   *TRAIN_LAUNCHER_ARGS, "--steps", str(steps),
                   "--ckpt-dir", d]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    cmd, cwd=ROOT, capture_output=True, text=True,
                    timeout=LAUNCHER_TIMEOUT_S,
                    env=dict(os.environ, PYTHONPATH=str(SRC)))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"[train:f] {' '.join(cmd[3:])} ran past "
                                   f"{LAUNCHER_TIMEOUT_S} s") from None
            need(proc.returncode == 0, f"[train:f] {' '.join(cmd[3:])}: "
                 f"exit {proc.returncode}: {proc.stderr.strip()[-2000:]}")
            want = ("fresh at step 0" if steps == TRAIN_LAUNCHER_STEPS[0]
                    else f"resumed at step {TRAIN_LAUNCHER_STEPS[0]}")
            need(want in proc.stdout and f"done at step {steps}"
                 in proc.stdout, f"[train:f] {proc.stdout!r}")
            out[steps] = {"stdout": proc.stdout.strip(),
                          "seconds": time.perf_counter() - t0}
            log(f"[train:f] --steps {steps}: "
                + proc.stdout.strip().replace(d, "<tmp>").replace("\n", " | ")
                + f" ({out[steps]['seconds']:.1f} s)")
    return out


def phase_train(ctx) -> dict:
    """12. train: granite-3-2b through ``Trainer`` at full width and depth,
    then the checks (b)-(g), on one process and a (1, 1) NCCL mesh."""
    from repro_torch.launch.mesh import make_local_mesh
    torch = ctx["torch"]
    t0 = time.perf_counter()
    live_gb = torch.cuda.memory_allocated() / 1e9
    log(f"[train] {live_gb:.2f} GB allocated on the card at the start")
    mesh = make_local_mesh()
    rec = {"live_gb_at_start": live_gb,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
    rec["dispatch"] = train_dispatch(ctx)
    log("[train:g] layers.flash_attention at phi3.5's attention shape, "
        "bf16: kernel 8 launches 1 under no_grad, 0 under grad; q/k/v "
        "grads equal the chunked path's bits")
    rec["full_width"] = train_full_width(ctx, mesh)
    rec.update(train_checks(ctx, mesh))
    rec["families_mesh"] = train_family_mesh(ctx, mesh)
    rec["resume"] = train_resume(ctx, mesh)
    rec["launcher"] = train_launcher(ctx)
    torch.distributed.destroy_process_group()      # make_local_mesh's
    rec["seconds"] = time.perf_counter() - t0
    log(f"[train] phase {rec['seconds']:.1f} s")
    ctx["report"]["train"] = rec
    return rec


# --------------------------------------------------------------------------
# the dry run's predictions against the card
# --------------------------------------------------------------------------
def dryrun_predictions() -> list:
    """(name, arch, layers or None for whole, remat or None for the
    config's) of every prediction of the dryrun phase."""
    return ([("a", TRAIN_ARCH, None, None)]
            + [(f"b:{a}", a, n, None) for a, n in DRYRUN_FAMILIES]
            + [(f"c:{r}", TRAIN_ARCH, DRYRUN_REMAT_LAYERS, r)
               for r in DRYRUN_REMATS])


def _dryrun_cfg(arch: str, layers, remat):
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    return cfg.replace(remat=remat) if remat else cfg


def dryrun_worker(out: str) -> int:
    """``--dryrun-worker OUT``: every prediction of the dryrun phase, one
    train step at B 8 x S 128 traced on a one-rank fake group
    (``launch.dryrun.run``), written to OUT as JSON."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, specs
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    res = {}
    for name, arch, layers, remat in dryrun_predictions():
        cfg = _dryrun_cfg(arch, layers, remat)
        rec = dryrun.run(cfg, shape, (1, 1))
        batch = sum(t.numel() * t.element_size()
                    for t in specs.train_batch_specs(cfg, shape).values())
        rec["state_bytes"] = rec["memory"]["argument_size_in_bytes"] - batch
        res[name] = rec
        log(f"[dryrun-worker] {name}: peak "
            f"{rec['memory']['peak_size_in_bytes'] / 1e9:.2f} GB, "
            f"{rec['hlo_cost']['dot_flops'] / 1e12:.3f} dot TFLOP, traced "
            f"in {rec['trace_s']:.1f} s")
    Path(out).write_text(json.dumps(res))
    return 0


def start_dryrun(ctx) -> None:
    """Start the dryrun phase's processes, which run on the host alone:
    the predictions (``--dryrun-worker``) and (d) the dry run's launcher
    on each cell of ``DRYRUN_CLIS``."""
    out = Path(ctx["out"]) / "dryrun_predictions.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    cmds = {"predict": [sys.executable, str(Path(__file__).resolve()),
                        "--dryrun-worker", str(out)],
            **{k: [sys.executable, *c] for k, c in DRYRUN_CLIS.items()}}
    # at a lower priority: the phases they overlap time the host
    ctx["dryrun"] = {"out": out, "t0": time.perf_counter(), "procs": {
        k: subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            preexec_fn=lambda: os.nice(10))
        for k, c in cmds.items()}}
    log("[dryrun] started the predictions and the dry run's launchers")


def stop_dryrun(ctx) -> None:
    for proc in ctx.get("dryrun", {}).get("procs", {}).values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _wait_dryrun(ctx, name: str) -> str:
    d = ctx["dryrun"]
    proc = d["procs"][name]
    left = DRYRUN_TIMEOUT_S - (time.perf_counter() - d["t0"])
    try:
        out, _ = proc.communicate(timeout=max(1.0, left))
    except subprocess.TimeoutExpired:
        stop_dryrun(ctx)
        raise SmokeFailure(f"[dryrun] {name} ran past {DRYRUN_TIMEOUT_S} s"
                           ) from None
    need(proc.returncode == 0,
         f"[dryrun] {name}: exit {proc.returncode}: {out[-3000:]}")
    d[f"{name}_seconds"] = time.perf_counter() - d["t0"]
    return out


def _batch_leaf(torch, name: str, spec, cfg, gen, dev):
    """A random batch leaf of ``spec``'s shape and dtype."""
    shape = tuple(spec.shape)
    if name in ("tokens", "labels"):
        return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                             device=dev, dtype=torch.int32)
    if name == "vis_mask":
        m = torch.zeros(shape, dtype=torch.bool, device=dev)
        m[:, :4] = True
        return m
    if name == "positions3":
        return torch.arange(shape[-1], device=dev, dtype=torch.int32
                            ).expand(shape).contiguous()
    return torch.randn(shape, generator=gen, device=dev).to(spec.dtype)


def card_step(ctx, mesh, cfg) -> dict:
    """``DRYRUN_STEPS`` train steps of ``cfg`` through ``make_train_step``
    on the one-rank mesh at B 8 x S 128 (the dry run's step): the peak
    (reset once the state and batch are made, less what the card held
    besides them), the last step's ms, loss and grad norm, kernel 8's
    and the WKV kernels' launches, and the FLOPs of the last step's
    products as
    ``FlopCounterMode`` counts them."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import specs
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.sharding import partition
    from repro_torch.train import train_step as ts
    from repro_torch.tree import leaves
    torch, dev = ctx["torch"], ctx["device"]
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    ocfg = OptConfig()
    gen = torch.Generator(device=dev).manual_seed(ctx["seed"] + 31)
    bspec = specs.train_batch_specs(cfg, shape)
    step, pspecs, bspecs = ts.make_train_step(
        cfg, ocfg, mesh, specs.state_specs(cfg, ocfg), bspec)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    state = partition.logical_to_sharding(
        ts.init_train_state(cfg, ocfg, gen, device=dev), pspecs, mesh)
    batch = partition.logical_to_sharding(
        {k: _batch_leaf(torch, k, t, cfg, gen, dev) for k, t in bspec.items()},
        bspecs, mesh)
    args = sum(t.to_local().numel() * t.to_local().element_size()
               for t in leaves([state, batch]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    secs = []
    for _ in range(DRYRUN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        secs.append(time.perf_counter() - t0)
    launches = read_launches()
    counter = FlopCounterMode(display=False)
    with counter:
        state, m = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del state, batch, m
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "remat": cfg.remat, "args_bytes": args,
            "peak_bytes": peak, "step_ms": [x * 1e3 for x in secs],
            "loss": loss, "grad_norm": gnorm,
            "kernel8_launches": launches["flash_attention"],
            "wkv_launches": [launches["wkv6"], launches["wkv6_bwd"]],
            "flops": counter.get_total_flops()}


def _vs(card: dict, pred: dict) -> dict:
    p = pred["memory"]["peak_size_in_bytes"]
    return {**card, "pred_peak_bytes": p,
            "pred_args_bytes": pred["memory"]["argument_size_in_bytes"],
            "peak_pred_over_card": p / card["peak_bytes"],
            "pred_dot_flops": pred["hlo_cost"]["dot_flops"],
            "flops_pred_over_card": pred["hlo_cost"]["dot_flops"]
            / card["flops"], "pred_trace_s": pred["trace_s"]}


def dryrun_cells(ctx) -> dict:
    """(d) of the dryrun phase: each launcher of ``DRYRUN_CLIS`` exited 0
    with status ok, granite's cells with ``fits_card``; each cell's peak,
    ``fits_card``, dot FLOPs and collective bytes by kind printed."""
    from repro_torch.launch import dryrun
    rec = {}
    for name, cli in DRYRUN_CLIS.items():
        out = _wait_dryrun(ctx, name)
        arch = cli[cli.index("--arch") + 1]
        shape = cli[cli.index("--shape") + 1]
        path = Path(dryrun.cell_path(arch, shape, "single"))
        cell = json.loads(path.read_text())
        need(cell.get("status") == "ok", f"[dryrun:d] {path.name}: "
             f"{cell.get('status')}: {cell.get('error', '')}")
        secs = ctx["dryrun"][f"{name}_seconds"]
        rec[f"{arch}|{shape}"] = {"cell": cell, "stdout": out[-2000:],
                                  "seconds": secs}
        m, h = cell["memory"], cell["hlo_cost"]
        peak = m["peak_size_in_bytes"] / 1e9
        coll = ", ".join(f"{k} {v / 1e9:.3f} GB ({h['collective_counts'][k]})"
                         for k, v in h["collective_bytes"].items() if v)
        log(f"[dryrun:d] python {' '.join(cli)}: exit 0, status ok in "
            f"{secs:.1f} s (trace {cell['trace_s']:.1f} s): per device args "
            f"{m['argument_size_in_bytes'] / 1e9:.3f} GB, peak {peak:.2f} GB, "
            f"fits_card {cell['fits_card']}; {h['dot_flops'] / 1e12:.4g} dot "
            f"TFLOP ({h['flops'] / 1e12:.4g} all); collectives {coll}")
        need(cell["fits_card"] or arch not in DRYRUN_FIT, f"[dryrun:d] "
             f"{arch} x {shape} on 16 x 16: peak {peak:.2f} GB does not "
             "fit the card")
        if shape == "decode_32k":
            rec[f"{arch}|{shape}"]["gathered"] = decode_vs_gathered(arch, h)
    return rec


def decode_vs_gathered(arch: str, h: dict) -> dict:
    """A (d) decode_32k cell's dot FLOPs, dot bytes and collectives beside
    ``GATHERED_DECODE``'s (the decode step that gathered every layer's
    weights); needs its all-gather bytes at most
    ``DRYRUN_DECODE_GATHER_SHARE`` of those: no weight is gathered."""
    old = GATHERED_DECODE[arch]
    new = {"dot_flops": h["dot_flops"], "dot_bytes": h["dot_bytes"],
           **{k: (h["collective_bytes"][k], h["collective_counts"][k])
              for k in ("all-gather", "all-reduce", "reduce-scatter")}}
    coll = "; ".join(f"{k} {old[k][0] / 1e9:.4g} GB ({old[k][1]}) -> "
                     f"{new[k][0] / 1e9:.4g} GB ({new[k][1]})"
                     for k in ("all-gather", "all-reduce", "reduce-scatter"))
    log(f"[dryrun:d] {arch} x decode_32k against the step that gathered "
        f"its weights: dot FLOPs {old['dot_flops']:.4g} -> "
        f"{new['dot_flops']:.4g}, dot bytes {old['dot_bytes'] / 1e9:.4g} -> "
        f"{new['dot_bytes'] / 1e9:.4g} GB; {coll}")
    need(new["all-gather"][0]
         <= DRYRUN_DECODE_GATHER_SHARE * old["all-gather"][0],
         f"[dryrun:d] {arch} x decode_32k all-gathers "
         f"{new['all-gather'][0] / 1e9:.4g} GB a step: more than "
         f"{DRYRUN_DECODE_GATHER_SHARE} of the weight-gathering step's "
         f"{old['all-gather'][0] / 1e9:.4g}")
    return {"before": old, "after": new}


def phase_dryrun(ctx) -> dict:
    """13. dryrun: the dry run's predictions of a train step (traced in a
    worker on a one-rank fake group) against the card: (a) granite-3-2b
    whole against the train phase's (a): state bytes exactly, the peak
    within 15%, the dot FLOPs within 2% of the products of a step on the
    card (``FlopCounterMode``; 8 N tokens + attention reported beside); (b)
    one step of each other family (finite loss and grad norm, no kernel
    8 launch under grad; rwkv6 whole, its WKV kernels launched as
    ``_wkv_per_step`` says) and (c) granite at 4 layers under remat
    "none", "dots" and "full", each with its step ms and measured against
    predicted peak; (d) the dry run's launcher on granite-3-2b and
    phi3.5-moe x train_4k and x decode_32k on the 16 x 16 mesh (fake
    256-rank groups; the sharded steps), on zamba2-2.7b and
    whisper-small x decode_32k and on rwkv6-1.6b x train_4k, exits 0
    with status ok, granite's, zamba2's, whisper's and rwkv6's with
    ``fits_card``, each cell's peak,
    ``fits_card``, dot FLOPs and collective bytes by kind printed, the
    decode_32k cells beside the weight-gathering step's and with no
    weight all-gathered."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    torch = ctx["torch"]
    t0 = time.perf_counter()
    _wait_dryrun(ctx, "predict")
    pred = json.loads(ctx["dryrun"]["out"].read_text())
    rec = {"predictions": pred,
           "predict_seconds": ctx["dryrun"]["predict_seconds"]}
    # (a)
    mesh = make_local_mesh()
    a, full = pred["a"], ctx["report"]["train"]["full_width"]
    whole = card_step(ctx, mesh, _dryrun_cfg(TRAIN_ARCH, None, None))
    peak = full["peak_gb"] * 1e9
    err_peak = a["memory"]["peak_size_in_bytes"] / peak - 1
    err_flops = a["hlo_cost"]["dot_flops"] / whole["flops"] - 1
    err_8n = a["hlo_cost"]["dot_flops"] / full["flops_per_step"] - 1
    rec["a"] = {"state_bytes": [a["state_bytes"], full["state_bytes"]],
                "peak_bytes": [a["memory"]["peak_size_in_bytes"], peak],
                "dot_flops": [a["hlo_cost"]["dot_flops"], whole["flops"],
                              full["flops_per_step"]],
                "peak_rel_err": err_peak, "flops_rel_err": err_flops,
                "flops_rel_to_8n": err_8n, "card_step": _vs(whole, a)}
    log(f"[dryrun:a] {TRAIN_ARCH} whole, B {TRAIN_BATCH} x S {TRAIN_SEQ}: "
        f"state {a['state_bytes']} bytes predicted, {full['state_bytes']} "
        f"on the card; peak {a['memory']['peak_size_in_bytes'] / 1e9:.2f} "
        f"GB predicted, {peak / 1e9:.2f} measured by the train phase "
        f"({err_peak:+.4f}; this phase's step {whole['peak_bytes'] / 1e9:.2f}"
        f"); dot FLOPs {a['hlo_cost']['dot_flops'] / 1e12:.4f} T predicted, "
        f"{whole['flops'] / 1e12:.4f} T counted on the card's step "
        f"({err_flops:+.5f}), 8 N tokens + attention "
        f"{full['flops_per_step'] / 1e12:.4f} T ({err_8n:+.4f})")
    need(a["state_bytes"] == full["state_bytes"],
         f"[dryrun:a] state bytes {a['state_bytes']} predicted, "
         f"{full['state_bytes']} on the card")
    need(abs(err_peak) <= DRYRUN_PEAK_TOL,
         f"[dryrun:a] peak off by {err_peak:+.3f}")
    need(abs(err_flops) <= DRYRUN_FLOP_TOL,
         f"[dryrun:a] dot FLOPs off by {err_flops:+.4f}")
    rec["b"], rec["c"] = {}, {}
    runs = ([("b", arch, _dryrun_cfg(arch, n, None), f"b:{arch}")
             for arch, n in DRYRUN_FAMILIES]
            + [("c", r, _dryrun_cfg(TRAIN_ARCH, DRYRUN_REMAT_LAYERS, r),
                f"c:{r}") for r in DRYRUN_REMATS])
    for part, key, cfg, name in runs:
        r = _vs(card_step(ctx, mesh, cfg), pred[name])
        rec[part][key] = r
        log(f"[dryrun:{part}] {cfg.name} at {cfg.n_layers} layers, remat "
            f"{cfg.remat}: loss {r['loss']:.4f}, grad norm "
            f"{r['grad_norm']:.3f}, step {r['step_ms'][-1]:.1f} ms; peak "
            f"{r['peak_bytes'] / 1e9:.2f} GB on the card, "
            f"{r['pred_peak_bytes'] / 1e9:.2f} predicted "
            f"({r['peak_pred_over_card']:.3f}x); dot FLOPs "
            f"{r['pred_dot_flops'] / 1e12:.4f} T predicted, "
            f"{r['flops'] / 1e12:.4f} counted ({r['flops_pred_over_card']:.4f}"
            f"x); kernel 8 launches {r['kernel8_launches']}"
            + (f", WKV (forward, backward) {r['wkv_launches']}"
               if wkv_expected(cfg) else ""))
        need(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]),
             f"[dryrun:{part}] {cfg.name}: loss {r['loss']}, grad norm "
             f"{r['grad_norm']}")
        need(r["kernel8_launches"] == 0, f"[dryrun:{part}] {cfg.name}: "
             f"kernel 8 launched {r['kernel8_launches']} times under grad")
        want_wkv = [DRYRUN_STEPS * n for n in _wkv_per_step(cfg)]
        need(r["wkv_launches"] == want_wkv, f"[dryrun:{part}] {cfg.name}: "
             f"WKV launches {r['wkv_launches']}, want {want_wkv}")
    torch.distributed.destroy_process_group()      # make_local_mesh's
    rec["d"] = dryrun_cells(ctx)
    rec["seconds"] = time.perf_counter() - t0
    log(f"[dryrun] phase {rec['seconds']:.1f} s (the predictions took "
        f"{rec['predict_seconds']:.1f} s beside the earlier phases)")
    ctx["report"]["dryrun"] = rec
    return rec


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
        "fp32": decode_parity(ctx, "fp32", cfg_fp, params_fp, sparse_fp),
        "int8_fused_vs_unfused": fused_vs_unfused(ctx, "int8", cfg, params,
                                                  sparse8),
        "fp32_fused_vs_unfused": fused_vs_unfused(ctx, "fp32", cfg_fp,
                                                  params_fp, sparse_fp)}
    report["decode_step"] = st = decode_step_profile(
        ctx, "decode_step_sparse int8", cfg,
        sparse_step(ctx, cfg, params, sparse8))
    want = sum(group_launches(cfg, sparse8).values())
    need(st.get("spmv_kernels_per_step") in (None, want),
         f"[step] {st.get('spmv_kernels_per_step')} SpMV kernels a step in "
         f"the profile, not {want} (one a group a layer)")
    entries = phase_kernels(ctx, sparse8, sparse_fp, launches_main)
    proj = phase_projection(ctx, params)
    phase_dense(ctx, cfg, params, cfg_fp, params_fp, sparse8, prompts, eng8)
    phase_robustness(ctx, cfg, params, cfg_fp, params_fp, sparse8, sparse_fp,
                     prompts, eng8)
    groups = new_kernel_cases(ctx, proj, sparse_fp)
    launches_main["espim_spmv"] = proj["launches"]["espim_spmv"]
    launches_main.update({k: v for k, v in phase_ops(ctx, groups).items()
                          if k in ("espim_spmv_batched_res", "dense_mv",
                                   "flash_attention")})
    entries += phase_new_kernels(ctx, groups, launches_main)
    from repro_torch.kernels.decode_attention import KERNELS_A_CALL
    need(eng8["decode_attention_per_layer_step"] == KERNELS_A_CALL,
         "[engine:int8] the decode attention kernels did not launch once a "
         "layer a decode step")
    da = phase_decode_attention(ctx)
    entries.append(_entry("decode_attention",
                          eng8["decode_attention_launches"],
                          da["rows"][0]["max_abs_err"], da["rows"][0]))
    report["mv_checks"] = mv_checks(
        ctx, {n: proj["layers"][(n, "fp32")].weights for n in ("qkv", "down")})
    fam = phase_families(ctx)
    wkv_rows = phase_wkv(ctx)
    # the dry run's processes use the host alone: they overlap the phases
    # timed on the device clock (autotune) and the train phase
    start_dryrun(ctx)
    phase_autotune(ctx, params, sparse8, sparse_fp)
    # the train phase needs ~55 GB: free llama7b's params and packs
    del params, params_fp, sparse8, sparse_fp, proj, groups
    gc.collect()
    torch.cuda.empty_cache()
    tr = phase_train(ctx)
    launches_main = {
        "wkv6": fam["models"]["rwkv6-1.6b"]["engine"]["launches"]["wkv6"],
        "wkv6_bwd": tr["families_mesh"]["rwkv6-1.6b"]["wkv_launches"][
            "make_train_step"][1]}
    entries += wkv_entries(wkv_rows, launches_main)
    phase_dryrun(ctx)
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    ap.add_argument("--dryrun-worker", metavar="OUT",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dryrun_worker:
        return dryrun_worker(args.dryrun_worker)
    t_start = time.perf_counter()
    # cuBLAS reads this at its first handle: the train phase's resume
    # drill runs with deterministic algorithms, which require it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
           "report": report, "timer": Timer(torch), "out": args.out,
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
    finally:
        stop_dryrun(ctx)
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
