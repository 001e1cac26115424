#!/usr/bin/env python3
"""A/B of the SpMV bodies on one NVIDIA GPU, in one process: the batched
ring body and kernel 5's mv body.

    python3 scripts/spmv_tile_ab.py [--seed N] [--out DIR] [--baseline CU]
                                    [--part ring|mv|both]

Builds, from ``src/repro_torch/kernels/csrc/espim_spmv.cu``, a throwaway
library that instantiates the ring body (``espim_spmv_stream_kernel`` for
kernels 1-2, ``espim_spmv_stream_glu_kernel`` for kernels 3-4) at shapes
of the ring the port itself does not launch: consumer warps a block,
the most stages and stage bytes, and whether x is staged in shared
memory where it fits or gathered through L1
(``RING_VARIANTS``; the grid is as many blocks as fit, fewer when the
rows are fewer), at the default warps a row (``WPRS``) and the port's
u = 2, in planes f32 and int8, at B = 1 and 4.  Each variant runs
one layer's groups of ``llama7b-espim`` at full width (random weights
from ``--seed``): the fp32 and int8 engines' QKV, O and down groups
(kernels 1-2) and their gate+up groups (kernels 3-4), one grouped launch
a group; the port's own entry points run beside them, grouped
(``espim_spmv_group``) and one launch a bucket (``espim_spmv_batched_fp``
and its siblings, at their default schedule).  Staging the x slabs of a
chunk in shared memory (one 512-column slab shared by a block's rows) is
not built: the variants stage the whole of x or none of it.

With ``--baseline`` it also builds another copy of ``espim_spmv.cu``
(say, the parent commit's) as it stands and times its four batched entry
points, one launch a bucket, as the variant "baseline", in the same
process and rounds (a source whose entry points predate the schedule's
``wpr`` and ``u`` arguments is called without them).

The mv part (kernel 5, the unbatched ``espim_spmv``) runs
``chip_smoke.py``'s kernel-5 cases: layer 0's wq / wk / wv (one
12288 x 4096 pack) and w_down (4096 x 11008) of its 2-layer model at 90%
sparsity, f32 planes with an f32 x and bf16 planes with a bf16 x, both
launches a call.  It times the port's launch (``espim_spmv_cuda`` on
``_mv_plan``'s plan), the same entry point on the port's plan with
another ring (``MV_RING_VARIANTS``: stages and the most bytes a stage,
in the same room), copies of the source with other consumer warps or
walks (``MV_SOURCE_VARIANTS``) on the port's plan, ``--baseline``'s
``espim_spmv`` entry called with its own signature (the earlier
12-argument one without a plan, or this one's with the port's plan),
and ``torch.matmul`` of the dense pruned bf16 weights, in rounds, in
order and then in reverse; then ``chip_smoke.mv_checks`` on the same
packs.

Each variant is checked against the plain version first (grouped: the
grouped plain version; per bucket: the bucket's; kernel 5: under
``chip_smoke._within``).  Timing is
``chip_smoke.Timer`` (CUDA events around replays of a captured CUDA
graph); the variants are timed in turns, in order and then in reverse,
and both rounds are reported.  At B = 4 each variant's launches are also
timed one by one, as ``chip_smoke`` times its buckets (``bucket_times``:
a graph of an L2-evicting read and the launch, less the read).  Prints a
table, the card's name and power limit; details go to
``<out>/spmv_tile_ab.json`` (the mv part: ``<out>/spmv_mv_ab.json``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# (consumer warps, most stages, most stage bytes, x staged in shared
# memory where it fits) of the ring
RING_VARIANTS = ((16, 5, 49152, 1), (16, 6, 32768, 1), (8, 5, 49152, 1),
                 (16, 5, 49152, 0))
WPRS = (0,)
PLANES = {"f32": 0, "int8": 1}           # enum Plane codes
# family -> {plane: the chip_smoke kernel whose cases it times}
FAMILIES = {"spmv": {"f32": "espim_spmv_batched",
                     "int8": "espim_spmv_batched_quant"},
            "glu": {"f32": "espim_spmv_batched_glu",
                    "int8": "espim_spmv_batched_quant_glu"}}
ENTRY_POINTS = ("espim_spmv_batched_fp", "espim_spmv_batched_quant",
                "espim_spmv_batched_glu_fp", "espim_spmv_batched_quant_glu")
# kernel 5: the rings the mv part times beside the port's plan's, (stages,
# most bytes a stage) in the room the port's plan gives the ring
MV_RING_VARIANTS = ((3, 49152), (4, 49152), (6, 32768), (2, 98304))
MV_ROUNDS = 3


def shim_source() -> str:
    """An extern "C" entry point over the ring variants: ab_group takes
    espim_spmv_group's arguments (f32 or int8 planes, B 1 or 4, at most
    kMaxBuckets buckets, U 2) and the variant's index first."""
    cu = ROOT / "src/repro_torch/kernels/csrc/espim_spmv.cu"
    lines = [f'#include "{cu}"', "namespace {",
             "template <class Cfg, int H>",
             "int ab_launch(int plane, GroupArgs& a, int wpr, void* s) {",
             "  const int rc = prepare<H, Cfg>(a, wpr);",
             "  if (rc != 0 || a.work == 0) return rc;",
             "  if (plane == 0 && a.b == 1) "
             "return launch_ring<kF32, 1, Cfg, H>(a, 2, s);",
             "  if (plane == 0 && a.b == 4) "
             "return launch_ring<kF32, 4, Cfg, H>(a, 2, s);",
             "  if (plane == 1 && a.b == 1) "
             "return launch_ring<kI8, 1, Cfg, H>(a, 2, s);",
             "  if (plane == 1 && a.b == 4) "
             "return launch_ring<kI8, 4, Cfg, H>(a, 2, s);",
             "  return -1;", "}", "}  // namespace", 'extern "C" {',
             "int ab_group(int var, int plane, int glu, int n, "
             "const void* values, const void* cols, const void* scales, "
             "const void* shapes, const void* x, const void* perm, "
             "void* out, int cc, int m, int b, int act, int wpr, "
             "void* s) {",
             "  if (n > kMaxBuckets) return -1;",
             "  GroupArgs a = group_args(0, n, values, cols, scales, shapes, "
             "x, perm, out, cc, m, b, act);"]
    for vi, (nc, st, sb, xs) in enumerate(RING_VARIANTS):
        cfg = f"Ring<{nc}, {st}, {sb}, {'true' if xs else 'false'}>"
        lines.append(f"  if (var == {vi}) return glu ? "
                     f"ab_launch<{cfg}, 2>(plane, a, wpr, s) : "
                     f"ab_launch<{cfg}, 1>(plane, a, wpr, s);")
    lines += ["  return -1;", "}", '}  // extern "C"', ""]
    return "\n".join(lines)


# the default schedule's (wpr, u) as the entry points take them
DEFAULT_SCHED = (0, 2)


def takes_schedule(cu: Path) -> bool:
    """Whether a source's batched entry points take ``wpr`` and ``u``."""
    return "int wpr, int u" in cu.read_text()


# kernel 5's phase probe: a copy of the source with the mv body's
# ``espim_spmv`` entry alone (no ring instance) and these edits, (anchor,
# text put before it, text put after it); slot i of a block's 16 (u64):
# 0 start, 1 last consumer end, 3 x landed, 6 first value barrier passed
# (%globaltimer ns); 4 / 5 consumer cycles waiting on barriers / walking
# (summed over warps); 7 producer cycles waiting on a free stage, 8 its
# end (ns); 9 / 10 the block's clock64 at its start and end
PROBE_EDITS = (
    ("// the launch: operands and the host's plan",
     "__device__ unsigned long long* mv_probe;\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
     "  return t;\n}\n"
     "#define PROBE(i) mv_probe[blockIdx.x * 16 + (i)]\n", ""),
    ("  for_mv_tiles(a, r_begin, r_end, [&](const MvTile& t) {\n"
     "    const int st = it % a.stages;\n"
     "    const uint32_t ph = (it / a.stages) & 1;\n"
     "    const uint32_t full_idx", "  long long t_pw = 0;\n", ""),
    ("    mbar_wait(bars + 8 * (2 * kMvMaxStages + st), ph ^ 1);\n",
     "    const long long tp_ = clock64();\n",
     "    t_pw += clock64() - tp_;\n"),
    ("}\n\n__device__ __forceinline__ float x_at",
     "  if (lane == 0 && mv_probe) {\n    PROBE(7) = t_pw;\n"
     "    PROBE(8) = gtime();\n  }\n", ""),
    ("  float acc = 0.0f;\n  int q = 0, it = 0;\n", "",
     "  long long t_wait = 0, t_walk = 0;\n"
     "  unsigned long long t_first = 0;\n"),
    ("    mbar_wait(bars + 8 * st, ph);\n    const int j0",
     "    const long long ti_ = clock64();\n", ""),
    ("    const int j0 = (t_id", "    t_wait += clock64() - ti_;\n", ""),
    ("      mbar_wait(bars + 8 * (kMvMaxStages + st), ph);\n",
     "      const long long tv_ = clock64();\n",
     "      t_wait += clock64() - tv_;\n"
     "      if (!t_first) t_first = gtime();\n"
     "      const long long tw_ = clock64();\n"),
    ("    }\n    if (t.s1 == slots) q += t.n;",
     "      t_walk += clock64() - tw_;\n", ""),
    ("}\n\n// FAST: vector loads",
     "  if (lane32 == 0 && mv_probe) {\n"
     "    atomicAdd(&PROBE(4), (unsigned long long)t_wait);\n"
     "    atomicAdd(&PROBE(5), (unsigned long long)t_walk);\n"
     "    if (t_first) atomicMin(&PROBE(6), t_first);\n  }\n", ""),
    ("  const int r_begin = blockIdx.x * a.rows_a_block;\n"
     "  const int r_end = min(a.rows, r_begin + a.rows_a_block);\n"
     "  // x, when staged",
     "  if (threadIdx.x == 0 && mv_probe) {\n    PROBE(0) = gtime();\n"
     "    PROBE(9) = clock64();\n  }\n", ""),
    ("  }\n  mv_consume<P, XT, FAST>(a, r_begin",
     "    if (threadIdx.x == 0 && mv_probe) PROBE(3) = gtime();\n", ""),
    ("  mv_consume<P, XT, FAST>(a, r_begin, r_end, ring_smem, bars, stages, x,"
     "\n                          part);\n", "",
     "  if (threadIdx.x % 32 == 0 && mv_probe) {\n"
     "    atomicMax(&PROBE(1), gtime());\n"
     "    atomicMax(&PROBE(10), (unsigned long long)clock64());\n  }\n"),
)


# kernel 5's body variants, each built from a copy of the source with
# its edits (old text, new text) and timed on the port's plans
MV_SOURCE_VARIANTS = {
    "8 consumer warps": (("constexpr int kMvConsumers = 16;",
                          "constexpr int kMvConsumers = 8;"),),
    "24 consumer warps": (("constexpr int kMvConsumers = 16;",
                           "constexpr int kMvConsumers = 24;"),),
    "walk 4 groups a turn": ((
        "    for (; s + step < s1; s += 2 * step) {\n"
        "      const int4 ca = *reinterpret_cast<const int4*>(cs + s);\n",
        "    for (; s + 3 * step < s1; s += 4 * step) {\n"
        "      int4 c[4];\n      float v[4][4];\n      int bs[4];\n"
        "#pragma unroll\n      for (int u = 0; u < 4; ++u) {\n"
        "        c[u] = *reinterpret_cast<const int4*>(cs + s + u * step);\n"
        "        smem_values4<P>(vs, s + u * step, v[u]);\n"
        "        bs[u] = base;\n"
        "        mv_advance(l, base, rk, qb, lc, cc);\n      }\n"
        "#pragma unroll\n      for (int u = 0; u < 4; ++u)\n"
        "        acc = gather4(x, bs[u], c[u], v[u], m, acc);\n    }\n"
        "    for (; s + step < s1; s += 2 * step) {\n"
        "      const int4 ca = *reinterpret_cast<const int4*>(cs + s);\n"),),
    "barriers polled by every lane": (
        ("    mbar_wait(bars + 8 * st, ph);\n    const int j0",
         "    while (!mbar_done(bars + 8 * st, ph)) {\n    }\n"
         "    const int j0"),
        ("      mbar_wait(bars + 8 * (kMvMaxStages + st), ph);\n",
         "      while (!mbar_done(bars + 8 * (kMvMaxStages + st), ph)) {\n"
         "      }\n")),
}


def mv_source(edits=(), probe: bool = False) -> str:
    """A copy of the source with the mv body's ``espim_spmv`` entry alone
    (no ring instance), ``edits`` (old, new) made, and with ``probe`` the
    phase probe (``PROBE_EDITS``) and ``mv_probe_set``, which points it
    at a device buffer of 16 u64 a block."""
    src = (ROOT / "src/repro_torch/kernels/csrc/espim_spmv.cu").read_text()
    head, ext = src.split('extern "C" {', 1)
    entry = re.search(r"int espim_spmv\(.*?\n}\n", ext, re.S).group(0)
    for old, new in edits:
        if head.count(old) != 1:
            raise RuntimeError(f"edit's text not found once: {old!r}")
        head = head.replace(old, new)
    setter = ""
    if probe:
        for anchor, before, after in PROBE_EDITS:
            if head.count(anchor) != 1:
                raise RuntimeError(f"probe anchor not found once: {anchor!r}")
            head = head.replace(anchor, before + anchor + after)
        setter = ("int mv_probe_set(void* p) {\n  return static_cast<int>("
                  "cudaMemcpyToSymbol(mv_probe, &p, sizeof(p)));\n}\n")
    return head + 'extern "C" {\n' + setter + entry + '}  // extern "C"\n'


def sass_counts(path, fn: str = "espim_spmv_mv_kernel") -> dict:
    """{instance: {opcode: count}} of the instructions of each ``fn``
    instance in ``cuobjdump --dump-sass`` of a library (LDS: shared
    loads, LD: generic, LDG: global; BAR, SHFL, FFMA and all)."""
    from repro_torch.kernels.build import find_nvcc
    tool = Path(find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "--dump-sass", str(path)],
                          capture_output=True, text=True, timeout=300).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if fn in m.group(1) else None
            if cur:
                out[cur] = {}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                      line)
        if cur and m:
            op = m.group(1)
            out[cur][op] = out[cur].get(op, 0) + 1
            out[cur]["all"] = out[cur].get("all", 0) + 1
    return out


def ring_variant(K, plan, slots: int, m: int, vb: int, xb: int,
                 stages: int, most: int):
    """The port's ``plan`` with a ring of ``stages`` stages of at most
    ``most`` bytes in the same room (x where the plan puts it), or None
    where such a stage would be under the least."""
    room = K.MV_SMEM - K.MV_BAR_BYTES - (K._x_region(m, xb)
                                         if plan.xstage else 0)
    stage = min(most, room // stages) // 128 * 128
    if stage < K.MV_MIN_STAGE:
        return None
    tile_rows, piece = K._mv_stage(stage, slots, vb, plan.team)
    return plan._replace(stages=stages, stage_bytes=stage,
                         tile_rows=tile_rows, piece=piece,
                         smem_bytes=plan.smem_bytes
                         + stages * stage - plan.stages * plan.stage_bytes)


def takes_mv_plan(cu: Path) -> bool:
    """Whether a source's ``espim_spmv`` entry takes a launch plan."""
    return "int tile_rows" in cu.read_text()


def build_libs(out_dir: Path, baseline: Path | None, shim: bool = True,
               probe: bool = False):
    """nvcc the shim (when ``shim``), with ``baseline`` that source as it
    stands, and kernel 5's phase probe (when ``probe``), all at once;
    returns ({"shim", "baseline", "probe": library or None, "mv_vars":
    {kernel 5's body variant: library}, "mv_ptxas": {variant: its ptxas
    summary}, "paths"}, seconds, the shim's ptxas summary)."""
    from repro_torch.kernels.build import NVCC_FLAGS, _SIGNATURES, find_nvcc
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    if shim:
        src = out_dir / "spmv_tile_ab.cu"
        src.write_text(shim_source())
        jobs["shim"] = (src, out_dir / "libspmv_tile_ab.so")
    if baseline is not None:
        jobs["baseline"] = (baseline.resolve(), out_dir / "libbaseline.so")
    if probe:
        src = out_dir / "mv_probe.cu"
        src.write_text(mv_source(probe=True))
        jobs["probe"] = (src, out_dir / "libmv_probe.so")
        for i, edits in enumerate(MV_SOURCE_VARIANTS.values()):
            src = out_dir / f"mv_var{i}.cu"
            src.write_text(mv_source(edits))
            jobs[f"mv_var{i}"] = (src, out_dir / f"libmv_var{i}.so")
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen([find_nvcc(), *NVCC_FLAGS, "-o", str(lib),
                                  str(cu)], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, (cu, lib) in jobs.items()}
    logs = {}
    for k, proc in procs.items():
        logs[k], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {jobs[k][0]}:\n{logs[k]}")
    build_s = time.perf_counter() - t0
    P, I = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for k, (cu, path) in jobs.items():
        lib = libs[k] = ctypes.CDLL(str(path))
        if k == "probe" or k.startswith("mv_var"):
            lib.espim_spmv.argtypes = _SIGNATURES["espim_spmv"]["espim_spmv"]
            if k == "probe":
                lib.mv_probe_set.argtypes = [P]
            continue
        sched = k == "shim" or takes_schedule(cu)
        fns = ENTRY_POINTS + (("espim_spmv_group",) if k == "shim" else ())
        for fn in fns:
            argtypes = _SIGNATURES["espim_spmv"][fn]
            # without the schedule: the same less (wpr, u) before stream
            getattr(lib, fn).argtypes = (argtypes if sched else
                                         argtypes[:-3] + argtypes[-1:])
            getattr(lib, fn).restype = I
        # kernel 5's entry: with the plan (this source's) or without
        lib.espim_spmv.argtypes = (_SIGNATURES["espim_spmv"]["espim_spmv"]
                                   if takes_mv_plan(cu) else
                                   [P, I, P, P, I, P] + [I] * 5 + [P])
        lib.espim_spmv.restype = I
    shim = libs.get("shim")
    if shim is not None:
        shim.ab_group.argtypes = [I, I, I, I] + [P] * 7 + [I] * 5 + [P]
        shim.ab_group.restype = I
    libs["mv_vars"] = {name: libs[f"mv_var{i}"]
                       for i, name in enumerate(MV_SOURCE_VARIANTS)
                       if f"mv_var{i}" in libs}
    libs["paths"] = {k: path for k, (_, path) in jobs.items()}
    libs["mv_ptxas"] = {name: ptxas_summary(logs[f"mv_var{i}"])
                        for i, name in enumerate(MV_SOURCE_VARIANTS)
                        if f"mv_var{i}" in logs}
    return ({k: libs.get(k) for k in ("shim", "baseline", "probe",
                                      "mv_vars", "mv_ptxas", "paths")},
            build_s, ptxas_summary(logs["shim"]) if shim else [])


def ptxas_summary(log: str) -> list:
    """One line per kernel: its template arguments and ptxas' register,
    stack and spill report."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"(espim_spmv_\w*?kernel)I(\w*?)EEv", ln)
        if m:
            args = re.findall(r"L[ib](\d+)E|EfL|EtL", m.group(2))
            name = f"{m.group(1)}<{','.join(a for a in args if a)}>"
        elif name and ("registers" in ln or "spill" in ln):
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return out


def launch_us(torch, timer, run, n) -> list:
    """Device µs of each of the ``n`` launches ``run(only=i)`` makes: the
    timer of a graph of a 128 MB read (evicting L2) and the launch, less
    the read's."""
    flush = torch.ones(32 << 20, device="cuda")
    t_flush = timer(flush.sum)
    return [(timer(lambda i=i: (flush.sum(), run(only=i))) - t_flush) * 1e3
            for i in range(n)]


def group_arrays(gc):
    """ctypes arrays of a group case: values, cols, srow pointers and the
    (rows, K, Lc, lv) shapes, as espim_spmv_group takes them."""
    n = len(gc["cols"])
    ptrs = ctypes.c_void_p * n
    glu = gc["act"] is not None
    shapes = []
    for v, c in zip(gc["values"], gc["cols"]):
        r, k, lc = c.shape
        shapes += [r // 2 if glu else r, k, lc, v.shape[-1]]
    return (ptrs(*[v.data_ptr() for v in gc["values"]]),
            ptrs(*[c.data_ptr() for c in gc["cols"]]),
            ptrs(*[t.data_ptr() for t in gc["srow"]]) if gc["srow"] else None,
            (ctypes.c_int * (4 * n))(*shapes))


def bucket_call(lib, family, plane, c, x, out, b, stream,
                sched=DEFAULT_SCHED) -> int:
    """One bucket's launch through a library's own entry point at the
    schedule ``sched`` — (wpr, u), or () for a source that predates the
    schedule's arguments."""
    r, k, lc = c["cols"].shape
    v = (c["values"] if plane == "f32" else c["q"]).data_ptr()
    cp, xp, op = c["cols"].data_ptr(), x.data_ptr(), out.data_ptr()
    if family == "spmv" and plane == "f32":
        return lib.espim_spmv_batched_fp(v, 0, cp, xp, op, r, k, lc, c["cc"],
                                         c["m"], b, *sched, stream)
    if family == "spmv":
        return lib.espim_spmv_batched_quant(v, 0, lc, cp, None, 1, xp, op, r,
                                            k, lc, c["cc"], c["m"], b, *sched,
                                            stream)
    if plane == "f32":
        return lib.espim_spmv_batched_glu_fp(v, 0, cp, xp, op, r // 2, k, lc,
                                             c["cc"], c["m"], b, 0, *sched,
                                             stream)
    return lib.espim_spmv_batched_quant_glu(v, 0, lc, cp,
                                            c["srow"].data_ptr(), xp, op,
                                            r // 2, k, lc, c["cc"], c["m"], b,
                                            0, *sched, stream)


def probe_stats(buf, launch_us: float) -> dict:
    """The phase probe's 16 u64 a block (``PROBE_EDITS``) of one launch
    -> its phases in µs and shares."""
    import numpy as np
    p = buf.cpu().numpy().astype(np.float64)
    g0, g1 = p[:, 0], p[:, 1]
    t0 = g0.min()
    dur = g1 - g0
    ghz = np.median((p[:, 10] - p[:, 9]) / np.maximum(dur, 1.0))
    cyc = p[:, 10] - p[:, 9]
    return {"launch_us": launch_us, "blocks": int(p.shape[0]),
            "span_us": (g1.max() - t0) / 1e3,
            "start_skew_us": [float(np.percentile(g0 - t0, q)) / 1e3
                              for q in (50, 100)],
            "x_landed_us": float(np.median(p[:, 3] - g0)) / 1e3,
            "first_tile_us": float(np.median(p[:, 6] - g0)) / 1e3,
            "block_us": [float(np.percentile(dur, q)) / 1e3
                         for q in (0, 50, 100)],
            "end_spread_us": float(g1.max() - np.median(g1)) / 1e3,
            "producer_end_to_block_end_us": float(np.median(g1 - p[:, 8]))
            / 1e3,
            "consumer_wait_share": float(p[:, 4].sum()
                                         / (p[:, 4] + p[:, 5]).sum()),
            "producer_wait_share": float(np.median(p[:, 7] / cyc)),
            "clock_ghz": float(ghz)}


def mv_part(torch, S, dev, args, libs, bw, card) -> None:
    """Kernel 5 at ``chip_smoke.py``'s shapes: the port's launch, the
    ``MV_RING_VARIANTS`` rings, the ``MV_SOURCE_VARIANTS`` bodies, the
    baseline's entry and ``torch.matmul``, checked and timed in rounds;
    each launch of the port's plan once more through the phase probe;
    the SASS of the port's mv instances; then ``chip_smoke.mv_checks``."""
    base, probe = libs["baseline"], libs["probe"]
    from repro_torch.configs.registry import get_config
    from repro_torch.core.espim_linear import ESPIMGroupLinear, ESPIMLinear
    from repro_torch.kernels import build
    from repro_torch.kernels import espim_spmv as K
    from repro_torch.kernels import ops
    from repro_torch.kernels.build import load_library
    from repro_torch.models.factory import init_params
    cfg = get_config(S.ARCH).replace(n_layers=S.N_LAYERS_INT8)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), device=dev)
    qkv = ("wq", "wk", "wv")
    attn, mlp = params["layers"]["attn"], params["layers"]["mlp"]
    host = {n: attn[n][0].T.float().cpu().numpy() for n in qkv}
    host["w_down"] = mlp["w_down"][0].T.float().cpu().numpy()
    del params, attn, mlp
    t0 = time.perf_counter()
    weights = {
        "qkv": ESPIMGroupLinear.from_dense(
            {n: host[n] for n in qkv}, prune_sparsity=S.PROJ_SPARSITY,
            device=dev).weights,
        "down": ESPIMLinear.from_dense(
            host["w_down"], prune_sparsity=S.PROJ_SPARSITY,
            device=dev).weights}
    print(f"[mv] packs {[tuple(w.cols.shape) for w in weights.values()]} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    lib, sms = load_library(), K._sm_count(dev)
    for ln in ptxas_summary(build.BUILD_LOG["espim_spmv"]["log"]):
        if "_mv_kernel" in ln:
            print(f"[mv]   {ln}")
    for vname, lines in libs["mv_ptxas"].items():
        for ln in lines:
            if "_mv_kernel" in ln and "registers" in ln:
                print(f"[mv]   src {vname}: {ln}")
    sass = sass_counts(build.library_path("espim_spmv"))
    for fn, ops_ in sass.items():
        print(f"[mv] SASS {fn}: " + ", ".join(
            f"{op} {ops_.get(op, 0)}" for op in
            ("all", "LDS", "LD", "LDG", "FFMA", "BAR", "SHFL", "SYNCS")))
    timer = S.Timer(torch)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 5)
    base_plan = args.baseline and takes_mv_plan(Path(args.baseline))
    rows, probes = [], []
    for dt, label in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        cases = []
        for w in weights.values():
            v, c = w.values.to(dt), w.cols
            x = torch.randn((w.n_cols,), generator=gen, device=dev).to(dt)
            cases.append({"v": v, "c": c, "x": x, "cc": w.chunk_cols,
                          "out": torch.empty(c.shape[0], device=dev),
                          "wb": S.dense_from_weights(torch, w).to(
                              torch.bfloat16),
                          "want": ops.espim_spmv(v, c, x,
                                                 chunk_cols=w.chunk_cols,
                                                 impl="ref")})
        nbytes = sum(k["v"].numel() * k["v"].element_size()
                     + k["c"].numel() * 4
                     + k["x"].numel() * k["x"].element_size()
                     + k["c"].shape[0] * 4 for k in cases)

        def plan_of(k, ring=None):
            r, n, lc = k["c"].shape
            m, vb, xb = (k["x"].shape[0], k["v"].element_size(),
                         k["x"].element_size())
            plan = K._mv_plan(r, n, lc, m, vb, xb, sms)
            return plan if ring is None else \
                ring_variant(K, plan, n * lc, m, vb, xb, *ring)

        def entry(lib, plans):
            """run() -> outputs: both launches through ``lib``'s entry,
            on ``plans`` (None: the entry takes no plan)."""
            def run():
                s = torch.cuda.current_stream().cuda_stream
                for k, plan in zip(cases, plans or [None] * len(cases)):
                    r, n, lc = k["c"].shape
                    a = (k["v"].data_ptr(), int(k["v"].dtype == torch.bfloat16),
                         k["c"].data_ptr(), k["x"].data_ptr(),
                         int(k["x"].dtype == torch.bfloat16),
                         k["out"].data_ptr(), r, n, lc, k["cc"],
                         k["x"].shape[0])
                    rc = (lib.espim_spmv(*a, s) if plan is None
                          else lib.espim_spmv(*a, *plan[:-1], s))
                    if rc != 0:
                        raise RuntimeError(f"espim_spmv rc {rc} on {plan}")
                return [k["out"].clone() for k in cases]
            return run

        runs = {"port": lambda: [K.espim_spmv_cuda(
            k["v"], k["c"], k["x"], chunk_cols=k["cc"]) for k in cases]}
        plans = {"port": [plan_of(k) for k in cases]}
        for ring in MV_RING_VARIANTS:
            lab = f"ring of {ring[0]} stages, at most {ring[1]} B"
            plans[lab] = [plan_of(k, ring) for k in cases]
            if None not in plans[lab]:
                runs[lab] = entry(lib, plans[lab])
        for vname, vlib in libs["mv_vars"].items():
            runs[f"src {vname}"] = entry(vlib, plans["port"])
        if base is not None:
            runs["baseline"] = entry(base, [plan_of(k) for k in cases]
                                     if base_plan else None)
        checks = {}
        for lab, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            errs = [S._within("espim_spmv", label, g, k["want"])
                    for g, k in zip(got, cases)]
            if not all(ok for ok, _ in errs):
                raise RuntimeError(f"mv {label} {lab}: max err "
                                   f"{[e for _, e in errs]}")
            checks[lab] = max(e for _, e in errs)
        runs["torch.matmul"] = lambda: [torch.matmul(k["wb"], k["x"].to(
            torch.bfloat16)) for k in cases]
        times = {lab: [] for lab in runs}
        order = list(runs)
        for i in range(MV_ROUNDS):
            for lab in (order if i % 2 == 0 else order[::-1]):
                times[lab].append(timer(runs[lab]))
        bound_us = nbytes / bw * 1e6
        for lab, ts in times.items():
            rec = {"dtype": label, "variant": lab, "bytes": nbytes,
                   "us_rounds": [t * 1e3 for t in ts],
                   "us": min(ts) * 1e3, "bound_us": bound_us,
                   "GBps": nbytes / (min(ts) * 1e-3) / 1e9,
                   "of_bound": bound_us / (min(ts) * 1e3),
                   "max_abs_err": checks.get(lab),
                   "plans": [p._asdict() for p in plans.get(lab, [])
                             if p]}
            rows.append(rec)
            print(f"[mv] {label} {lab:44s} "
                  + " / ".join(f"{t:6.1f}" for t in rec["us_rounds"])
                  + f" us ({rec['GBps']:5.0f} GB/s, {rec['of_bound']:.1%} of "
                  f"the {bound_us:.1f} us bound)", flush=True)
        for lab, ps in plans.items():
            print(f"[mv] {label} {lab} plans: "
                  + "; ".join(str(tuple(p)) if p else "under the least stage"
                              for p in ps))
        for name, k, plan in zip(weights, cases, plans["port"]):
            buf = torch.zeros((plan.blocks, 16), dtype=torch.int64,
                              device=dev)
            probe.mv_probe_set(buf.data_ptr())
            one = [k]
            t_one = timer(lambda one=one: [K.espim_spmv_cuda(
                c["v"], c["c"], c["x"], chunk_cols=c["cc"]) for c in one])
            for _ in range(3):      # the last of three launches
                buf.zero_()
                buf[:, 6] = 2 ** 63 - 1
                r, n, lc = k["c"].shape
                rc = probe.espim_spmv(
                    k["v"].data_ptr(), int(k["v"].dtype == torch.bfloat16),
                    k["c"].data_ptr(), k["x"].data_ptr(),
                    int(k["x"].dtype == torch.bfloat16), k["out"].data_ptr(),
                    r, n, lc, k["cc"], k["x"].shape[0], *plan[:-1],
                    torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                if rc != 0:
                    raise RuntimeError(f"probe rc {rc}")
            if not S._within("espim_spmv", label, k["out"], k["want"])[0]:
                raise RuntimeError(f"probe {label} {name}: wrong sums")
            st = probe_stats(buf, t_one * 1e3)
            st.update(dtype=label, pack=name)
            probes.append(st)
            print(f"[mv] probe {label} {name}: launch {st['launch_us']:.1f} "
                  f"us, span {st['span_us']:.1f}, start skew "
                  f"{st['start_skew_us'][0]:.2f}/{st['start_skew_us'][1]:.2f}"
                  f", x landed {st['x_landed_us']:.2f}, first tile "
                  f"{st['first_tile_us']:.2f}, block min/med/max "
                  + "/".join(f"{t:.1f}" for t in st["block_us"])
                  + f", end spread {st['end_spread_us']:.2f}, producer done "
                  f"{st['producer_end_to_block_end_us']:.2f} before its "
                  f"block; consumers wait {st['consumer_wait_share']:.0%}, "
                  f"producer waits {st['producer_wait_share']:.0%} "
                  f"({st['clock_ghz']:.2f} GHz)", flush=True)
    ctx = {"torch": torch, "device": dev, "seed": args.seed}
    extra = S.mv_checks(ctx, weights)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "spmv_mv_ab.json").write_text(json.dumps(
        {"card": card, "device": torch.cuda.get_device_name(0),
         "baseline": args.baseline, "rings": MV_RING_VARIANTS,
         "sources": list(MV_SOURCE_VARIANTS),
         "shapes": {n: list(w.cols.shape) for n, w in weights.items()},
         "rows": rows, "probes": probes, "checks": extra,
         "sass": sass}, indent=1,
        default=str))


def ring_part(torch, S, dev, args, lib, base, bw, build_s, regs) -> None:
    """The ring body's variants and the port's batched entry points on
    one layer's groups at B = 1 and 4 (the module's note)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.sparse_model import sparsify_model
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    base_sched = (DEFAULT_SCHED if args.baseline
                  and takes_schedule(Path(args.baseline)) else ())
    name, card = torch.cuda.get_device_name(0), S.nvidia_smi()
    cfg = get_config(S.ARCH).replace(n_layers=1)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev)
    packs = {q or "f32": sparsify_model(cfg, params, cfg.espim_sparsity,
                                        projections="all", quant=q,
                                        device=dev)
             for q in (None, "int8")}
    ctx = {"torch": torch}
    gcases = [gc for gc in S.group_cases(ctx, packs["int8"], packs["f32"])
              if gc["variant"] in ("fp32", "int8")]
    sel = {(fam, plane): [gc for gc in gcases if gc["kernel"] == kern]
           for fam, kerns in FAMILIES.items()
           for plane, kern in kerns.items()}
    timer = S.Timer(torch)
    xgen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    xs = {(m, b): torch.randn((m, b), generator=xgen, device=dev)
          for m in {gc["m"] for gc in gcases} for b in (1, 4)}
    outs = {}

    def launcher(family, plane, kind, var, wpr, b):
        """run(check, only) -> outputs: one launch a group (grouped kinds)
        or a bucket (per-bucket kinds) of the family's groups."""
        glu = int(family == "glu")
        arrays = {}

        def run(check=False, only=None):
            stream = torch.cuda.current_stream().cuda_stream
            res, i = [], -1
            for gi, gc in enumerate(sel[(family, plane)]):
                x = xs[(gc["m"], b)]
                if kind in ("ring", "port"):
                    i += 1
                    if only is not None and i != only:
                        continue
                    key = (family, plane, gi, b)
                    if key not in outs:
                        outs[key] = torch.empty(
                            (gc["n_out"] or sum(c.shape[0] // (1 + glu)
                                                for c in gc["cols"]), b),
                            device=dev)
                    if gi not in arrays:
                        arrays[gi] = group_arrays(gc)
                    vp, cp, sp, sh = arrays[gi]
                    a = (PLANES[plane], glu, len(gc["cols"]),
                         ctypes.addressof(vp), ctypes.addressof(cp),
                         ctypes.addressof(sp) if sp else None,
                         ctypes.addressof(sh), x.data_ptr(),
                         gc["perm"].data_ptr() if gc["perm"] is not None
                         else None, outs[key].data_ptr(), gc["cc"], gc["m"],
                         b, 0)
                    rc = (lib.ab_group(var, *a, wpr, stream) if kind == "ring"
                          else lib.espim_spmv_group(*a, 0, 2, stream))
                    if rc != 0:
                        raise RuntimeError(f"{family} {plane} {kind} {var} "
                                           f"B={b}: rc {rc}")
                    if check:
                        res.append(outs[key].clone())
                    continue
                for bi, c in enumerate(gc["buckets"]):
                    i += 1
                    if only is not None and i != only:
                        continue
                    key = (family, plane, gi, bi, b)
                    if key not in outs:
                        outs[key] = torch.empty(
                            (c["cols"].shape[0] // (1 + glu), b), device=dev)
                    rc = (bucket_call(lib, family, plane, c, x, outs[key], b,
                                      stream) if kind == "port-bucket"
                          else bucket_call(base, family, plane, c, x,
                                           outs[key], b, stream, base_sched))
                    if rc != 0:
                        raise RuntimeError(f"{family} {plane} {kind} B={b}: "
                                           f"rc {rc}")
                    if check:
                        res.append(outs[key].clone())
            return res
        return run

    variants = [("ring", vi, w, f"ring NC={nc} S={st} {sb // 1024}KB "
                 f"x{'smem' if xs else 'L1'} wpr={w}")
                for vi, (nc, st, sb, xs) in enumerate(RING_VARIANTS)
                for w in WPRS]
    variants += [("port", 0, 0, "port grouped (espim_spmv_group)"),
                 ("port-bucket", 0, 0, "port per bucket")]
    if base is not None:
        variants.append(("baseline", 0, 0, "baseline per bucket"))
    rows = []
    for (family, plane), groups in sel.items():
        for b in (1, 4):
            xb = {gc["m"]: xs[(gc["m"], b)] for gc in groups}
            want_g = [S.run_group(ops, gc, xb[gc["m"]], "ref")
                      for gc in groups]
            want_b = [S.run_case(ops, c, xb[gc["m"]], "ref")
                      for gc in groups for c in gc["buckets"]]
            bks = [c for gc in groups for c in gc["buckets"]]
            nbytes = sum(S.case_bytes(c, b)[0] for c in bks)
            runs = {}
            for kind, var, wpr, label in variants:
                run = launcher(family, plane, kind, var, wpr, b)
                got = run(check=True)
                torch.cuda.synchronize()
                want = want_g if kind in ("ring", "port") else want_b
                err = max(float((g - w).abs().max()) for g, w in
                          zip(got, want))
                tol = min(S.KERNEL_REL_TOL * float(w.abs().max())
                          + S.KERNEL_ABS_TOL for w in want)
                if not (len(got) == len(want) and err <= tol):
                    raise RuntimeError(f"{family} {plane} B={b} {label}: max "
                                       f"err {err:.3e} > {tol:.3e}")
                runs[label] = (run, err, len(got))
            times = {label: [] for label in runs}
            for order in (list(runs), list(runs)[::-1]):
                for label in order:
                    times[label].append(timer(runs[label][0]))
            per_launch = ({label: launch_us(torch, timer, run, n)
                           for label, (run, _, n) in runs.items()}
                          if b == 4 else {})
            for label, ts in times.items():
                rec = {"family": family, "plane": plane, "B": b,
                       "variant": label,
                       "per_launch_us": per_launch.get(label),
                       "launches": runs[label][2], "bytes": nbytes,
                       "us_rounds": [t * 1e3 for t in ts],
                       "us": min(ts) * 1e3,
                       "GBps": nbytes / (min(ts) * 1e-3) / 1e9,
                       "bound_us": nbytes / bw * 1e6,
                       "max_abs_err": runs[label][1]}
                rows.append(rec)
                print(f"[ab] {family:4s} {plane:4s} B={b} {label:36s} "
                      + " / ".join(f"{t:7.1f}" for t in rec["us_rounds"])
                      + f" us ({rec['GBps']:5.0f} GB/s, bound "
                      f"{rec['bound_us']:.1f} us, {rec['launches']} "
                      "launches)", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "spmv_tile_ab.json").write_text(json.dumps(
        {"card": card, "device": name, "build_seconds": build_s,
         "baseline": args.baseline, "ptxas": regs,
         "ring_variants": RING_VARIANTS,
         "shapes": {f"{f}/{p}": [[list(c.shape) for c in gc["cols"]]
                                 for gc in s]
                    for (f, p), s in sel.items()},
         "rows": rows}, indent=1))
    for (family, plane), groups in sel.items():
        print(f"[ab] {family} {plane} B=4 per launch (us), groups "
              + ", ".join(gc["group"] for gc in groups))
        for rec in rows:
            if (rec["family"], rec["plane"]) == (family, plane) \
                    and rec["per_launch_us"]:
                print(f"[ab]   {rec['variant']:36s} "
                      + " ".join(f"{t:6.1f}" for t in rec["per_launch_us"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    ap.add_argument("--baseline", default=None,
                    help="another espim_spmv.cu whose entry points to time")
    ap.add_argument("--part", choices=("ring", "mv", "both"),
                    default="both", help="the ring body's A/B, kernel 5's "
                    "or both")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as S
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    name, card = torch.cuda.get_device_name(0), S.nvidia_smi()
    bw = S.card_bandwidth(name)
    # the port's own library builds beside the shim and the baseline
    port = threading.Thread(target=build.build_all, args=(["espim_spmv"],))
    port.start()
    libs, build_s, regs = build_libs(
        ROOT / "build" / "repro_torch" / "ab",
        Path(args.baseline) if args.baseline else None,
        shim=args.part != "mv", probe=args.part != "ring")
    port.join()
    print(f"[ab] {name} ({card}); built in {build_s:.1f} s", flush=True)
    for ln in regs:
        print(f"[ab]   {ln}")
    if args.part != "ring":
        mv_part(torch, S, dev, args, libs, bw, card)
    if args.part != "mv":
        ring_part(torch, S, dev, args, libs["shim"], libs["baseline"], bw,
                  build_s, regs)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
