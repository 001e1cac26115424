#!/usr/bin/env python3
"""A/B of the batched SpMV bodies on one NVIDIA GPU, in one process.

    python3 scripts/spmv_tile_ab.py [--seed N] [--out DIR] [--baseline CU]

Builds, from ``src/repro_torch/kernels/csrc/espim_spmv.cu``, a throwaway
library that instantiates variants the port itself does not launch:

* the warp-per-row body (``espim_spmv_kernel``, kernel 5, and kernels
  1-2 and 6 before the streaming body) at batch tiles 1, 4 and 8;
* the streaming body (``espim_spmv_stream_kernel``, kernels 1-2) at
  several (U groups in flight a lane, warps a row), beside the port's own
  entry points (``espim_spmv_batched_fp``, ``espim_spmv_batched_quant``),
  which pick U and the warps a row themselves;
* its GLU variant (``espim_spmv_stream_glu_kernel``, kernels 3-4) in
  design a (a team walks the gate row, then the up row) and design b
  (half the team's warps on each row) at several (U, warps a pair),
  beside the port's own entry points (``espim_spmv_batched_glu_fp``,
  ``espim_spmv_batched_quant_glu``).

With ``--baseline`` it also builds another copy of ``espim_spmv.cu``
(say, the parent commit's) as it stands and times its four batched entry
points as the variant "baseline", in the same process and rounds.

Then times each on one layer's launches of kernels 1-4 (the fp32
engine's QKV / O / down and gate+up buckets, and the int8 engine's) of
``llama7b-espim`` at full width (random weights from ``--seed``, one
layer), at B = 1 and B = 4, each variant checked against the plain
version first.  Timing is ``chip_smoke.Timer`` (CUDA events around
replays of a captured CUDA graph); the variants are timed in turns, in
order and then in reverse, and both rounds are reported.  At B = 4 each
variant's launches are also timed one by one, as ``chip_smoke`` times
its buckets (``bucket_times``: a graph of an L2-evicting read and the
launch, less the read).  Prints a table, the card's name and power
limit; details go to ``<out>/spmv_tile_ab.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

OLD_TILES = (1, 4, 8)
# (U groups in flight a lane, warps a row) of the streaming body
STREAM_VARIANTS = tuple((u, w) for u in (1, 2, 4, 8) for w in (1, 2, 4))
# (design, U, warps a pair) of its GLU variant; design b needs 2 warps
GLU_VARIANTS = tuple(("a", u, w) for u in (1, 2, 4) for w in (1, 2, 4)) + \
    tuple(("b", u, w) for u in (1, 2, 4) for w in (2, 4))
PLANES = {"f32": "kF32", "int8": "kI8"}
# family -> {plane: the chip_smoke kernel whose cases it times}
FAMILIES = {"spmv": {"f32": "espim_spmv_batched",
                     "int8": "espim_spmv_batched_quant"},
            "glu": {"f32": "espim_spmv_batched_glu",
                    "int8": "espim_spmv_batched_quant_glu"}}
ENTRY_POINTS = ("espim_spmv_batched_fp", "espim_spmv_batched_quant",
                "espim_spmv_batched_glu_fp", "espim_spmv_batched_quant_glu")


def shim_source() -> str:
    """extern "C" entry points over the variants, one switch each."""
    cu = ROOT / "src/repro_torch/kernels/csrc/espim_spmv.cu"
    lines = [f'#include "{cu}"', 'extern "C" {',
             "int ab_old(int p, int bt, const void* v, const void* c, "
             "const void* x, void* out, int rows, int k, int lc, int cc, "
             "int m, int b, void* s) {"]
    for pi, (_, pc) in enumerate(PLANES.items()):
        for bt in OLD_TILES:
            lines.append(
                f"  if (p == {pi} && bt == {bt}) return launch<{pc}, "
                f"float, {bt}>(v, static_cast<const int*>(c), "
                "static_cast<const float*>(x), "
                "static_cast<float*>(out), rows, k, lc, lc, cc, m, b, s);")
    lines += ["  return -1;", "}",
              "int ab_stream(int p, int var, const void* v, const void* c, "
              "const void* x, void* out, int rows, int k, int lc, int cc, "
              "int m, int b, void* s) {",
              "  const int* ci = static_cast<const int*>(c);",
              "  const float* xf = static_cast<const float*>(x);",
              "  float* o = static_cast<float*>(out);"]
    for pi, (_, pc) in enumerate(PLANES.items()):
        lines.append(f"  const int mode{pi} = stream_mode<{pc}>(v, ci, xf, "
                     "lc, lc, b);")
        for vi, (u, wpr) in enumerate(STREAM_VARIANTS):
            for bt in (1, 4):
                lines.append(
                    f"  if (p == {pi} && var == {vi} && b == {bt}) return "
                    f"launch_stream_tile<{pc}, {bt}, {u}>(v, ci, xf, nullptr, "
                    f"nullptr, o, rows, k, lc, lc, cc, m, b, 1, mode{pi}, "
                    f"{wpr}, s);")
    lines += ["  return -1;", "}",
              "int ab_glu(int p, int var, const void* v, const void* c, "
              "const void* srow, const void* x, void* out, int rows_g, "
              "int k, int lc, int cc, int m, int b, int act, void* s) {",
              "  const int* ci = static_cast<const int*>(c);",
              "  const float* xf = static_cast<const float*>(x);",
              "  const float* sr = static_cast<const float*>(srow);",
              "  float* o = static_cast<float*>(out);"]
    for pi, (_, pc) in enumerate(PLANES.items()):
        lines.append(f"  const int gmode{pi} = stream_mode<{pc}>(v, ci, xf, "
                     "lc, lc, b);")
        for vi, (design, u, wpr) in enumerate(GLU_VARIANTS):
            split = "true" if design == "b" else "false"
            for bt in (1, 4):
                lines.append(
                    f"  if (p == {pi} && var == {vi} && b == {bt}) return "
                    f"launch_glu_tile<{pc}, {bt}, {u}, {split}>(v, ci, xf, "
                    f"sr, o, rows_g, k, lc, lc, cc, m, b, gmode{pi}, {wpr}, "
                    "act, s);")
    lines += ["  return -1;", "}", '}  // extern "C"', ""]
    return "\n".join(lines)


def build_libs(out_dir: Path, baseline: Path | None):
    """nvcc the shim and, with ``baseline``, that source as it stands, both
    at once; returns (shim library, baseline library or None, seconds,
    ptxas summary)."""
    from repro_torch.kernels.build import NVCC_FLAGS, _SIGNATURES, find_nvcc
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "spmv_tile_ab.cu"
    src.write_text(shim_source())
    jobs = {"shim": (src, out_dir / "libspmv_tile_ab.so")}
    if baseline is not None:
        jobs["baseline"] = (baseline.resolve(), out_dir / "libbaseline.so")
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
    for k, (_, path) in jobs.items():
        lib = libs[k] = ctypes.CDLL(str(path))
        for fn in ENTRY_POINTS:
            getattr(lib, fn).argtypes = _SIGNATURES["espim_spmv"][fn]
            getattr(lib, fn).restype = I
    shim = libs["shim"]
    shim.ab_old.argtypes = [I, I, P, P, P, P, I, I, I, I, I, I, P]
    shim.ab_stream.argtypes = [I, I, P, P, P, P, I, I, I, I, I, I, P]
    shim.ab_glu.argtypes = [I, I, P, P, P, P, P, I, I, I, I, I, I, I, P]
    shim.ab_old.restype = shim.ab_stream.restype = shim.ab_glu.restype = I
    return shim, libs.get("baseline"), build_s, ptxas_summary(logs["shim"])


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


def entry_call(lib, family, plane, c, v, x, out, b, stream) -> int:
    """One launch through a library's own entry point (its tile, U, warps
    a row and design)."""
    r, k, lc = c["cols"].shape
    cp, xp, op = c["cols"].data_ptr(), x.data_ptr(), out.data_ptr()
    if family == "spmv" and plane == "f32":
        return lib.espim_spmv_batched_fp(v, 0, cp, xp, op, r, k, lc, c["cc"],
                                         c["m"], b, stream)
    if family == "spmv":
        return lib.espim_spmv_batched_quant(v, 0, lc, cp, None, 1, xp, op, r,
                                            k, lc, c["cc"], c["m"], b, stream)
    if plane == "f32":
        return lib.espim_spmv_batched_glu_fp(v, 0, cp, xp, op, r // 2, k, lc,
                                             c["cc"], c["m"], b, 0, stream)
    return lib.espim_spmv_batched_quant_glu(v, 0, lc, cp,
                                            c["srow"].data_ptr(), xp, op,
                                            r // 2, k, lc, c["cc"], c["m"], b,
                                            0, stream)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    ap.add_argument("--baseline", default=None,
                    help="another espim_spmv.cu whose entry points to time")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as S
    from repro_torch.configs.registry import get_config
    from repro_torch.core.sparse_model import sparsify_model
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    name, card = torch.cuda.get_device_name(0), S.nvidia_smi()
    bw = S.card_bandwidth(name)
    lib, base, build_s, regs = build_libs(
        ROOT / "build" / "repro_torch" / "ab",
        Path(args.baseline) if args.baseline else None)
    print(f"[ab] {name} ({card}); shim built in {build_s:.1f} s", flush=True)
    for ln in regs:
        print(f"[ab]   {ln}")
    cfg = get_config(S.ARCH).replace(n_layers=1)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev)
    packs = {q or "f32": sparsify_model(cfg, params, cfg.espim_sparsity,
                                        projections="all", quant=q,
                                        device=dev)
             for q in (None, "int8")}
    ctx = {"torch": torch}
    cases = S.kernel_cases(ctx, packs["int8"], packs["f32"])
    sel = {(fam, plane): [c for c in cases if c["kernel"] == kern
                          and c["variant"] in ("fp32", "int8")]
           for fam, kerns in FAMILIES.items()
           for plane, kern in kerns.items()}
    timer = S.Timer(torch)
    xgen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    xs = {(m, b): torch.randn((m, b), generator=xgen, device=dev)
          for m in {c["m"] for c in cases} for b in (1, 4)}
    outs = {}

    def launcher(family, plane, kind, var, b):
        pi = list(PLANES).index(plane)

        def run(check=False, only=None):
            stream = torch.cuda.current_stream().cuda_stream
            res = []
            for i, c in enumerate(sel[(family, plane)]):
                if only is not None and i != only:
                    continue
                v = (c["values"] if plane == "f32" else c["q"]).data_ptr()
                r, k, lc = c["cols"].shape
                rows_out = r // 2 if family == "glu" else r
                key = (family, plane, i, b)
                if key not in outs:
                    outs[key] = torch.empty((rows_out, b), device=dev)
                x, o = xs[(c["m"], b)], outs[key]
                if kind in ("port", "baseline"):
                    rc = entry_call(lib if kind == "port" else base, family,
                                    plane, c, v, x, o, b, stream)
                elif kind == "old":
                    rc = lib.ab_old(pi, var, v, c["cols"].data_ptr(),
                                    x.data_ptr(), o.data_ptr(), r, k, lc,
                                    c["cc"], c["m"], b, stream)
                elif kind == "stream":
                    rc = lib.ab_stream(pi, var, v, c["cols"].data_ptr(),
                                       x.data_ptr(), o.data_ptr(), r, k, lc,
                                       c["cc"], c["m"], b, stream)
                else:
                    rc = lib.ab_glu(pi, var, v, c["cols"].data_ptr(),
                                    c["srow"].data_ptr() if plane == "int8"
                                    else None, x.data_ptr(), o.data_ptr(),
                                    rows_out, k, lc, c["cc"], c["m"], b, 0,
                                    stream)
                if rc != 0:
                    raise RuntimeError(f"{family} {plane} {kind} {var} "
                                       f"B={b}: rc {rc}")
                if check:
                    res.append(o.clone())
            return res
        return run

    variants = {
        "spmv": ([("old", bt, f"warp-per-row BT={bt}") for bt in OLD_TILES]
                 + [("stream", vi, f"stream U={u} warps/row={w}")
                    for vi, (u, w) in enumerate(STREAM_VARIANTS)]),
        "glu": [("glu", vi, f"glu {d} U={u} warps/pair={w}")
                for vi, (d, u, w) in enumerate(GLU_VARIANTS)]}
    for fam in variants:
        variants[fam].append(("port", 0, "port (its design, U, warps)"))
        if base is not None:
            variants[fam].append(("baseline", 0, "baseline (--baseline)"))
    rows = []
    for (family, plane), sel_fp in sel.items():
        for b in (1, 4):
            nbytes = sum(S.case_bytes(c, b)[0] for c in sel_fp)
            want = [S.run_case(ops, c, xs[(c["m"], b)], "ref")
                    for c in sel_fp]
            runs = {}
            for kind, var, label in variants[family]:
                run = launcher(family, plane, kind, var, b)
                got = run(check=True)
                torch.cuda.synchronize()
                err = max(float((g - w).abs().max()) for g, w in
                          zip(got, want))
                tol = max(S.KERNEL_REL_TOL * float(w.abs().max())
                          + S.KERNEL_ABS_TOL for w in want)
                if not err <= tol:
                    raise RuntimeError(f"{family} {plane} B={b} {label}: max "
                                       f"err {err:.3e} > {tol:.3e}")
                runs[label] = (run, err)
            times = {label: [] for label in runs}
            for order in (list(runs), list(runs)[::-1]):
                for label in order:
                    times[label].append(timer(runs[label][0]))
            per_launch = ({label: launch_us(torch, timer, run, len(sel_fp))
                           for label, (run, _) in runs.items()}
                          if b == 4 else {})
            for label, ts in times.items():
                rec = {"family": family, "plane": plane, "B": b,
                       "variant": label,
                       "per_launch_us": per_launch.get(label),
                       "launches": len(sel_fp), "bytes": nbytes,
                       "us_rounds": [t * 1e3 for t in ts],
                       "us": min(ts) * 1e3,
                       "GBps": nbytes / (min(ts) * 1e-3) / 1e9,
                       "bound_us": nbytes / bw * 1e6,
                       "max_abs_err": runs[label][1]}
                rows.append(rec)
                print(f"[ab] {family:4s} {plane:4s} B={b} {label:30s} "
                      + " / ".join(f"{t:7.1f}" for t in rec["us_rounds"])
                      + f" us ({rec['GBps']:5.0f} GB/s, bound "
                      f"{rec['bound_us']:.1f} us, {len(sel_fp)} launches)",
                      flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "spmv_tile_ab.json").write_text(json.dumps(
        {"card": card, "device": name, "build_seconds": build_s,
         "baseline": args.baseline, "ptxas": regs,
         "shapes": {f"{f}/{p}": [list(c["cols"].shape) for c in s]
                    for (f, p), s in sel.items()},
         "rows": rows}, indent=1))
    for (family, plane), sel_fp in sel.items():
        print(f"[ab] {family} {plane} B=4 per launch (us), shapes "
              + ", ".join(str(tuple(c["cols"].shape)) for c in sel_fp))
        for rec in rows:
            if (rec["family"], rec["plane"]) == (family, plane) \
                    and rec["per_launch_us"]:
                print(f"[ab]   {rec['variant']:30s} "
                      + " ".join(f"{t:6.1f}" for t in rec["per_launch_us"]))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
