#!/usr/bin/env python3
"""A/B of the batched SpMV bodies on one NVIDIA GPU, in one process.

    python3 scripts/spmv_tile_ab.py [--seed N] [--out DIR]

Builds, from ``src/repro_torch/kernels/csrc/espim_spmv.cu``, a throwaway
library that instantiates variants the port itself does not launch:

* the warp-per-row body (``espim_spmv_kernel``, kernels 3-6, and kernels
  1-2 before the streaming body) at batch tiles 1, 4 and 8;
* the streaming body (``espim_spmv_stream_kernel``, kernels 1-2) at
  several (U groups in flight a lane, warps a row), beside the port's own
  entry points (``espim_spmv_batched_f32``, ``espim_spmv_batched_quant``),
  which pick U and the warps a row themselves.

Then times each on one layer's launches of kernel 1 (the fp32 engine's
QKV / O / down buckets) and kernel 2 (the int8 engine's) of
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
PLANES = {"f32": "kF32", "int8": "kI8"}


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
                f"  if (p == {pi} && bt == {bt}) return launch<{pc}, false, "
                f"float, {bt}>(v, static_cast<const int*>(c), "
                "static_cast<const float*>(x), nullptr, nullptr, "
                "static_cast<float*>(out), rows, k, lc, lc, cc, m, b, 1, 0, "
                "s);")
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
                    f"o, rows, k, lc, lc, cc, m, b, 1, mode{pi}, {wpr}, s);")
    lines += ["  return -1;", "}", '}  // extern "C"', ""]
    return "\n".join(lines)


def build_shim(out_dir: Path):
    from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "spmv_tile_ab.cu"
    src.write_text(shim_source())
    lib_path = out_dir / "libspmv_tile_ab.so"
    t0 = time.perf_counter()
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(lib_path),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ab_old.argtypes = [I, I, P, P, P, P, I, I, I, I, I, I, P]
    lib.ab_stream.argtypes = [I, I, P, P, P, P, I, I, I, I, I, I, P]
    lib.ab_old.restype = lib.ab_stream.restype = I
    from repro_torch.kernels.build import _SIGNATURES
    for fn in ("espim_spmv_batched_f32", "espim_spmv_batched_quant"):
        getattr(lib, fn).argtypes = _SIGNATURES["espim_spmv"][fn]
        getattr(lib, fn).restype = I
    return lib, time.perf_counter() - t0, ptxas_summary(proc.stdout
                                                         + proc.stderr)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
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
    lib, build_s, regs = build_shim(ROOT / "build" / "repro_torch" / "ab")
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
    sel = {"f32": [c for c in cases if c["kernel"] == "espim_spmv_batched"],
           "int8": [c for c in cases if c["kernel"] ==
                    "espim_spmv_batched_quant" and c["variant"] == "int8"]}
    timer = S.Timer(torch)
    xgen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    xs = {(m, b): torch.randn((m, b), generator=xgen, device=dev)
          for m in {c["m"] for c in cases} for b in (1, 4)}
    outs = {}

    def launcher(plane, kind, var, b):
        pi = list(PLANES).index(plane)
        fn = lib.ab_old if kind == "old" else lib.ab_stream

        def port(pi, var, v, c, x, o, r, k, lc, cc, m, b, stream):
            """the port's own entry point: its tile, U and warps a row"""
            if pi == 0:
                return lib.espim_spmv_batched_f32(v, c, x, o, r, k, lc, cc, m,
                                                  b, stream)
            return lib.espim_spmv_batched_quant(v, 0, lc, c, None, 1, x, o, r,
                                                k, lc, cc, m, b, stream)

        if kind == "port":
            fn = port

        def run(check=False, only=None):
            stream = torch.cuda.current_stream().cuda_stream
            res = []
            for i, c in enumerate(sel[plane]):
                if only is not None and i != only:
                    continue
                v = c["values"] if plane == "f32" else c["q"]
                r, k, lc = c["cols"].shape
                key = (plane, i, b)
                if key not in outs:
                    outs[key] = torch.empty((r, b), device=dev)
                rc = fn(pi, var, v.data_ptr(), c["cols"].data_ptr(),
                        xs[(c["m"], b)].data_ptr(), outs[key].data_ptr(), r,
                        k, lc, c["cc"], c["m"], b, stream)
                if rc != 0:
                    raise RuntimeError(f"{plane} {kind} {var} B={b}: rc {rc}")
                if check:
                    res.append(outs[key].clone())
            return res
        return run

    variants = ([("old", bt, f"warp-per-row BT={bt}") for bt in OLD_TILES]
                + [("stream", vi, f"stream U={u} warps/row={w}")
                   for vi, (u, w) in enumerate(STREAM_VARIANTS)]
                + [("port", 0, "port (its U, warps a row by rows)")])
    rows = []
    for plane in PLANES:
        for b in (1, 4):
            sel_b = sel[plane]
            nbytes = sum(S.case_bytes(c, b)[0] for c in sel_b)
            want = [S.run_case(ops, c, xs[(c["m"], b)], "ref")
                    for c in sel_b]
            runs = {}
            for kind, var, label in variants:
                run = launcher(plane, kind, var, b)
                got = run(check=True)
                torch.cuda.synchronize()
                err = max(float((g - w).abs().max()) for g, w in
                          zip(got, want))
                tol = max(S.KERNEL_REL_TOL * float(w.abs().max())
                          + S.KERNEL_ABS_TOL for w in want)
                if not err <= tol:
                    raise RuntimeError(f"{plane} B={b} {label}: max err "
                                       f"{err:.3e} > {tol:.3e}")
                runs[label] = (run, err)
            times = {label: [] for label in runs}
            for order in (list(runs), list(runs)[::-1]):
                for label in order:
                    times[label].append(timer(runs[label][0]))
            per_launch = ({label: launch_us(torch, timer, run, len(sel_b))
                           for label, (run, _) in runs.items()}
                          if b == 4 else {})
            for label, ts in times.items():
                rec = {"plane": plane, "B": b, "variant": label,
                       "per_launch_us": per_launch.get(label),
                       "launches": len(sel_b), "bytes": nbytes,
                       "us_rounds": [t * 1e3 for t in ts],
                       "us": min(ts) * 1e3,
                       "GBps": nbytes / (min(ts) * 1e-3) / 1e9,
                       "bound_us": nbytes / bw * 1e6,
                       "max_abs_err": runs[label][1]}
                rows.append(rec)
                print(f"[ab] {plane:4s} B={b} {label:32s} "
                      + " / ".join(f"{t:7.1f}" for t in rec["us_rounds"])
                      + f" us ({rec['GBps']:5.0f} GB/s, bound "
                      f"{rec['bound_us']:.1f} us, {len(sel_b)} launches)",
                      flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "spmv_tile_ab.json").write_text(json.dumps(
        {"card": card, "device": name, "build_seconds": build_s,
         "ptxas": regs, "shapes": {p: [list(c["cols"].shape) for c in s]
                                   for p, s in sel.items()},
         "rows": rows}, indent=1))
    for plane in PLANES:
        print(f"[ab] {plane} B=4 per launch (us), shapes "
              + ", ".join(str(tuple(c["cols"].shape)) for c in sel[plane]))
        for rec in rows:
            if rec["plane"] == plane and rec["per_launch_us"]:
                print(f"[ab]   {rec['variant']:32s} "
                      + " ".join(f"{t:6.1f}" for t in rec["per_launch_us"]))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
