#!/usr/bin/env python3
"""A/B of the dense MV body's variants on one NVIDIA GPU, in one process.

    python3 scripts/dense_mv_ab.py [--seed N] [--out DIR] [--baseline CU]

Builds, from ``src/repro_torch/kernels/csrc/dense_mv.cu``, a throwaway
library that instantiates the streaming body (``dense_mv_kernel``) over
U (16-byte W loads in flight a lane: 2, 4, 8) x warps a row (1, 2, 4),
for fp32 W and x and for bf16 W and x, beside the port's own entry point
(``dense_mv``, which picks its variant) and ``torch.mv``, which the port
never calls.  With ``--baseline`` it also builds another ``dense_mv.cu``
as it stands (say, the parent commit's) and times its entry point as the
variant "baseline", in the same rounds.

Every variant is first checked against the plain version
(``kernels/ref.dense_mv_ref``) under ``chip_smoke``'s limits (fp32
1e-5 max|plain| + 1e-6; bf16 elementwise 5e-2 + 5e-2 |plain|) and
launched twice for identical bits, then timed at W (4096, 4096),
(4096, 11008) and (11008, 4096) with ``chip_smoke.Timer`` (CUDA events
around replays of a captured CUDA graph), in order and then in reverse,
both rounds reported, beside the bound (W's, x's and y's bytes at the
card's data-sheet memory rate).  Prints a table, each kernel's registers
(ptxas) and the card's name and power limit; details go to
``<out>/dense_mv_ab.json``.
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

SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))
# (U, warps a row) of the streaming body
VARIANTS = tuple((u, w) for u in (2, 4, 8) for w in (1, 2, 4))
TYPES = {"fp32": "float", "bf16": "unsigned short"}


def label(u: int, wpr: int) -> str:
    return f"U={u} warps/row={wpr}"


def shim_source() -> str:
    """``ab_dense(bf16, var, ...)``: one launch of variant ``var``."""
    cu = ROOT / "src/repro_torch/kernels/csrc/dense_mv.cu"
    lines = [f'#include "{cu}"', 'extern "C" {',
             "int ab_dense(int bf16, int var, const void* w, const void* x, "
             "void* y, int rows, int cols, int vec, void* s) {"]
    for flag, dtype in ((0, "fp32"), (1, "bf16")):
        t = TYPES[dtype]
        lines.append(f"  if (bf16 == {flag}) switch (var) {{")
        for i, (u, wpr) in enumerate(VARIANTS):
            lines.append(f"    case {i}: return launch_body<{t}, {t}, {u}>"
                         f"(w, x, y, rows, cols, vec, {wpr}, s);")
        lines.append("  }")
    lines += ["  return -1;", "}", '}  // extern "C"', ""]
    return "\n".join(lines)


def build_libs(out_dir: Path, baseline: Path | None):
    """nvcc the shim and, with ``baseline``, that source as it stands, at
    once; returns ({name: library}, shim's nvcc log, seconds)."""
    from repro_torch.kernels.build import NVCC_FLAGS, _SIGNATURES, find_nvcc
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "dense_mv_ab.cu"
    src.write_text(shim_source())
    jobs = {"shim": (src, out_dir / "libdense_mv_ab.so")}
    if baseline is not None:
        jobs["baseline"] = (baseline.resolve(),
                            out_dir / "libdense_baseline.so")
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
        lib.dense_mv.argtypes = _SIGNATURES["dense_mv"]["dense_mv"]
        lib.dense_mv.restype = I
    libs["shim"].ab_dense.argtypes = [I, I, P, P, P, I, I, I, P]
    libs["shim"].ab_dense.restype = I
    return libs, logs["shim"], build_s


def ptxas_summary(log: str) -> list:
    """One line per kernel: its template arguments and ptxas' register,
    stack and spill report."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"(dense_mv_kernel)I(\w*?)EEv", ln)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>"
        elif name and ("registers" in ln or "spill" in ln):
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    ap.add_argument("--baseline", default=None,
                    help="another dense_mv.cu whose entry point to time")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as S
    from repro_torch.kernels.ref import dense_mv_ref
    dev = torch.device("cuda")
    name, card = torch.cuda.get_device_name(0), S.nvidia_smi()
    bw = S.card_bandwidth(name)
    libs, log, build_s = build_libs(ROOT / "build" / "repro_torch" / "ab",
                                    Path(args.baseline) if args.baseline
                                    else None)
    regs = ptxas_summary(log)
    print(f"[ab] {name} ({card}); shim built in {build_s:.1f} s", flush=True)
    for ln in regs:
        print(f"[ab]   {ln}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}
    kinds = [("variant", i, label(*v)) for i, v in enumerate(VARIANTS)]
    kinds.append(("entry", 0, "port entry point"))
    if "baseline" in libs:
        kinds.append(("baseline", 0, "baseline (--baseline)"))
    rows, checks, bad = [], [], []
    timer = S.Timer(torch)
    for r, c in SHAPES:
        for dtype in ("fp32", "bf16"):
            w = torch.randn((r, c), generator=gen, device=dev).to(tdt[dtype])
            x = torch.randn((c,), generator=gen, device=dev).to(tdt[dtype])
            y = torch.empty((r,), device=dev)
            bf16 = int(dtype == "bf16")
            want = dense_mv_ref(w, x)
            ptrs = (w.data_ptr(), x.data_ptr(), y.data_ptr())

            def runner(kind, var):
                def run():
                    s = torch.cuda.current_stream().cuda_stream
                    if kind == "variant":
                        rc = libs["shim"].ab_dense(bf16, var, *ptrs, r, c, 1,
                                                   s)
                    else:
                        lib = libs["shim" if kind == "entry" else kind]
                        rc = lib.dense_mv(ptrs[0], bf16, ptrs[1], bf16,
                                          ptrs[2], r, c, 1, s)
                    if rc != 0:
                        raise RuntimeError(f"{kind} {var} {r}x{c}: rc {rc}")
                    return y
                return run

            runs = {}
            for kind, var, lab in kinds:
                run = runner(kind, var)
                got = run().clone()
                again = run().clone()
                torch.cuda.synchronize()
                ok, err = S._within("dense_mv", dtype, got, want)
                same = torch.equal(got, again)
                checks.append({"shape": [r, c], "dtype": dtype,
                               "variant": lab, "ok": ok, "max_abs_err": err,
                               "bit_identical": same})
                if not (ok and same):
                    bad.append(checks[-1])
                    print(f"[check] {dtype} {r}x{c} {lab}: max|kernel-plain| "
                          f"{err:.3e}{'' if ok else ' OUT OF TOLERANCE'}"
                          f"{'' if same else ', RERUN BITS DIFFER'}",
                          flush=True)
                    continue
                runs[lab] = run
            runs["torch.mv (library)"] = lambda w=w, x=x: torch.mv(w, x)
            nbytes = (w.numel() + x.numel()) * w.element_size() + r * 4
            times = {lab: [] for lab in runs}
            for order in (list(runs), list(runs)[::-1]):
                for lab in order:
                    times[lab].append(timer(runs[lab]))
            for lab, ts in times.items():
                us = min(ts) * 1e3
                rec = {"shape": [r, c], "dtype": dtype, "variant": lab,
                       "us_rounds": [t * 1e3 for t in ts], "us": us,
                       "TBps": nbytes / (us * 1e-6) / 1e12,
                       "bound_us": nbytes / bw * 1e6}
                rows.append(rec)
                print(f"[ab] {dtype} {r:5d}x{c:5d} {lab:32s} "
                      + " / ".join(f"{t:7.1f}" for t in rec["us_rounds"])
                      + f" us ({rec['TBps']:.2f} TB/s, bound "
                      f"{rec['bound_us']:.1f} us)", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "dense_mv_ab.json").write_text(json.dumps(
        {"card": card, "device": name, "build_seconds": build_s,
         "baseline": args.baseline, "ptxas": regs, "checks": checks,
         "rows": rows}, indent=1))
    # the best variant per (shape, dtype), and each variant's sum over them
    by = {}
    for rec in rows:
        by.setdefault(rec["variant"], {})[(tuple(rec["shape"]),
                                           rec["dtype"])] = rec["us"]
    cells = sorted({k for v in by.values() for k in v})
    for lab, t in sorted(by.items(), key=lambda kv: sum(kv[1].values())):
        if len(t) == len(cells):
            print(f"[ab] sum over shapes {sum(t.values()):8.1f} us  {lab}")
    print(card)
    if bad:
        print(f"FAIL: {len(bad)} checks out of tolerance or not "
              "bit-identical", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
