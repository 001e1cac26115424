#!/usr/bin/env python3
"""A/B of the flash attention body's variants on one NVIDIA GPU, in one
process.

    python3 scripts/attn_tile_ab.py [--dtype bf16|fp32|both] [--seed N]
                                    [--out DIR] [--baseline CU]

Builds, from ``src/repro_torch/kernels/csrc/flash_attention.cu``, a
throwaway library that instantiates, at hd = 128:

* bf16: the wgmma + TMA body (``flash_attention_wgmma_kernel``) over key
  tile (64, 128) x stages (2, 3) x consumer warpgroups (1, 2);
* fp32: the 3xTF32 ``mma.sync`` body (``flash_attention_tf32_kernel``)
  over key tile (32, 64) x warps (4, 8);

beside the port's own entry point (``flash_attention``, which launches
one of them) and ``scaled_dot_product_attention``, which the port never
calls.  The library is built with ``FLASH_WAIT_LIMIT``, so a fault in the
wgmma body's pipeline traps instead of hanging the card.  With
``--baseline`` it also builds another ``flash_attention.cu`` as it
stands (say, the parent commit's) and times its entry point as the
variant "baseline", in the same rounds.

Every variant is first checked against the plain version
(``kernels/ref.flash_attention_ref``) under ``chip_smoke``'s attention
limits (``chip_smoke._within``: fp32 elementwise 2e-5 + 2e-5 |plain|;
bf16 elementwise 5e-2 + 5e-2 |plain| and, over the whole output,
||kernel - plain||_2 / ||plain||_2 within ``chip_smoke.REL_L2_TOL``) at
BH = 4, S in {77, 200, 512}, causal and full, and launched twice for
identical bits; the entry point also at hd 32 and 64.  Then each is
timed at BH = 32, hd = 128 and S in {77, 512, 2048}, causal and full
(the entry point, the baseline and SDPA also at S = 200, hd 32 and 64),
after the same check at that shape: ``chip_smoke.Timer`` (CUDA events
around replays of a captured CUDA graph), in order and then in reverse,
both rounds reported, beside the bound (flops at the dtype's peak in
``chip_smoke.PEAKS``).  It also reports the host cost of encoding the
wgmma body's three tensor maps, each kernel's registers and spills
(ptxas) and its tensor-core instructions (``cuobjdump``: HGMMA for wgmma,
HMMA for mma.sync), and, with ``--baseline``, whether each kernel of the
port's library has the same SASS instructions as the baseline's kernel
of that name.  Prints a table and the card's name and power limit;
details go to ``<out>/attn_tile_ab.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

HD = 128
# dtype -> (label, launcher template call) of every variant the shim
# instantiates
VARIANTS = {
    "bf16": tuple((f"wgmma BK={bk} stages={st} wg={wg}",
                   f"launch_wgmma<128, {bk}, {st}, {wg}>")
                  for bk in (64, 128) for st in (2, 3) for wg in (1, 2)),
    "fp32": tuple((f"tf32x3 BK={bk} warps={nw}",
                   f"launch_tf32<128, {bk}, {nw}>")
                  for bk in (32, 64) for nw in (4, 8)),
}
# the peak each dtype's bound is reckoned at (chip_smoke.PEAKS)
PEAK_KEY = {"bf16": "bf16_tensor", "fp32": "tf32x3_tensor"}
CHECK_BH, CHECK_SEQS = 4, (77, 200, 512)
TIME_BH, TIME_SEQS = 32, (77, 512, 2048)
# (S, hd) timed too, for the entry point, the baseline and SDPA only: the
# ragged shapes of chip_smoke's other head widths
TIME_RAGGED = ((200, 32), (200, 64))
WAIT_LIMIT = 2_000_000_000            # clocks, ~1 s: a fault, not a wait


def shim_source() -> str:
    """``ab_flash(variant, ...)`` over the variants and ``ab_encode_ns``,
    the host time of one call's three tensor-map encodes."""
    cu = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"
    lines = [f'#include "{cu}"', "#include <chrono>", 'extern "C" {',
             "int ab_flash(int bf16, int var, const void* q, const void* k, "
             "const void* v, void* out, int bh, int seq, int causal, "
             "float scale, void* s) {"]
    for flag, dtype in ((1, "bf16"), (0, "fp32")):
        lines.append(f"  if (bf16 == {flag}) switch (var) {{")
        for i, (_, call) in enumerate(VARIANTS[dtype]):
            lines.append(f"    case {i}: return {call}(q, k, v, out, bh, "
                         "seq, causal, scale, s);")
        lines.append("  }")
    lines += ["  return -1;", "}",
              "double ab_encode_ns(const void* q, int bh, int seq, int n) {",
              "  CUtensorMap map;",
              "  const auto t0 = std::chrono::steady_clock::now();",
              "  for (int i = 0; i < 3 * n; ++i)",
              "    if (tensor_map<128>(&map, q, bh, seq, 128) != 0) "
              "return -1.0;",
              "  const auto t1 = std::chrono::steady_clock::now();",
              "  return std::chrono::duration<double, std::nano>(t1 - t0)"
              ".count() / n;", "}", '}  // extern "C"', ""]
    return "\n".join(lines)


def build_libs(out_dir: Path, baseline: Path | None):
    """nvcc the shim and, with ``baseline``, that source as it stands, at
    once; returns ({name: library}, {name: nvcc log}, seconds)."""
    from repro_torch.kernels.build import NVCC_FLAGS, _SIGNATURES, find_nvcc
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "attn_tile_ab.cu"
    src.write_text(shim_source())
    jobs = {"shim": (src, out_dir / "libattn_tile_ab.so",
                     [f"-DFLASH_WAIT_LIMIT={WAIT_LIMIT}LL"])}
    if baseline is not None:
        jobs["baseline"] = (baseline.resolve(),
                            out_dir / "libattn_baseline.so", [])
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen([find_nvcc(), *NVCC_FLAGS, *extra, "-o",
                                  str(lib), str(cu)], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, (cu, lib, extra) in jobs.items()}
    logs = {}
    for k, proc in procs.items():
        logs[k], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {jobs[k][0]}:\n{logs[k]}")
    build_s = time.perf_counter() - t0
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for k, (_, path, _) in jobs.items():
        lib = libs[k] = ctypes.CDLL(str(path))
        lib.flash_attention.argtypes = _SIGNATURES["flash_attention"][
            "flash_attention"]
        lib.flash_attention.restype = I
    shim = libs["shim"]
    shim.ab_flash.argtypes = [I, I, P, P, P, P, I, I, I, F, P]
    shim.ab_flash.restype = I
    shim.ab_encode_ns.argtypes = [P, I, I, I]
    shim.ab_encode_ns.restype = ctypes.c_double
    return libs, logs, build_s, {k: str(p) for k, (_, p, _) in jobs.items()}


def ptxas_summary(log: str) -> list:
    """One line per flash kernel: its template arguments and ptxas'
    register, stack and spill report."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"(flash_attention_\w*?kernel)I(\w*?)EEv", ln)
        if m:               # template arguments as mangled: t = bf16 bits
            name = f"{m.group(1)}<{m.group(2)}>"
        elif name and ("registers" in ln or "spill" in ln):
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return out


def sass_bodies(path) -> dict:
    """{kernel name without its file's namespace: its SASS instructions,
    without addresses and encodings}, from ``cuobjdump --dump-sass``."""
    from repro_torch.kernels.build import find_nvcc
    tool = Path(find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "--dump-sass", str(path)],
                          capture_output=True, text=True, timeout=300).stdout
    out, fn = {}, None
    for line in text.splitlines():
        # the mangled name after its length digits, without the file's
        # namespace (which differs between two sources)
        m = re.search(r"Function : \S*?(?<=\d)(flash_attention_\w*kernelI\w*)",
                      line)
        if m:
            fn = m.group(1)
            out[fn] = []
        elif fn:
            m = re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?)\s*;", line)
            if m:
                out[fn].append(m.group(1))
    return out


def write(args, card, name, build_s, regs, sass, encode_us, checks, rows):
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "attn_tile_ab.json").write_text(json.dumps(
        {"card": card, "device": name, "build_seconds": build_s,
         "baseline": args.baseline, "ptxas": regs, "sass": sass,
         "encode_us_per_call": encode_us, "checks": checks, "rows": rows},
        indent=1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bf16", "fp32", "both"),
                    default="both")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    ap.add_argument("--baseline", default=None,
                    help="another flash_attention.cu whose entry point to "
                         "time")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import chip_smoke as S
    from repro_torch.kernels.build import build as build_library
    from repro_torch.kernels.ref import flash_attention_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    name, card = torch.cuda.get_device_name(0), S.nvidia_smi()
    libs, logs, build_s, paths = build_libs(
        ROOT / "build" / "repro_torch" / "ab",
        Path(args.baseline) if args.baseline else None)
    lib = libs["shim"]
    regs = ptxas_summary(logs["shim"])
    sass = S.sass_tensor_ops(paths["shim"])
    print(f"[ab] {name} ({card}); shim built in {build_s:.1f} s", flush=True)
    for ln in regs:
        print(f"[ab]   {ln}")
    for fn, counts in sass.items():
        print(f"[ab]   SASS {fn}: {counts}")
    if "baseline" in paths:         # the entry points' kernels, compared
        mine = sass_bodies(build_library("flash_attention"))
        theirs = sass_bodies(paths["baseline"])
        for fn in sorted(set(mine) & set(theirs)):
            same = mine[fn] == theirs[fn]
            print(f"[ab]   SASS of {fn} {'equals' if same else 'differs from'}"
                  f" the baseline's ({len(mine[fn])} / {len(theirs[fn])} "
                  "instructions)")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    dtypes = ("bf16", "fp32") if args.dtype == "both" else (args.dtype,)
    tdt = {"bf16": torch.bfloat16, "fp32": torch.float32}

    def qkv(bh, seq, hd, dtype):
        return [torch.randn((bh, seq, hd), generator=gen, device=dev).to(
            tdt[dtype]) for _ in range(3)]

    def runner(kind, var, q, k, v, causal):
        out = torch.empty_like(q)
        bh, seq, hd = q.shape
        bf16 = int(q.dtype == torch.bfloat16)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())

        def run():
            stream = torch.cuda.current_stream().cuda_stream
            if kind == "variant":
                rc = lib.ab_flash(bf16, var, *ptrs, bh, seq, int(causal),
                                  1.0 / math.sqrt(hd), stream)
            else:
                rc = libs[kind].flash_attention(*ptrs, bf16, bh, seq, hd,
                                                int(causal),
                                                1.0 / math.sqrt(hd), stream)
            if rc != 0:
                raise RuntimeError(f"{kind} {var} S={seq} hd={hd}: rc {rc}")
            return out
        return run

    def check(label, run, q, k, v, causal, dtype):
        want = flash_attention_ref(q, k, v, causal)
        got = run().clone()
        again = run().clone()
        torch.cuda.synchronize()
        ok, err = S._within("flash_attention", dtype, got, want)
        rel = S.rel_l2(got, want)
        same = torch.equal(got, again)
        bh, seq, hd = q.shape
        what = (f"{dtype} {label} BH={bh} S={seq} hd={hd} "
                f"{'causal' if causal else 'full'}")
        print(f"[check] {what}: max|kernel-plain| {err:.3e}, rel L2 "
              f"{rel:.3e} {'ok' if ok else 'OUT OF TOLERANCE'}"
              f"{'' if same else ', RERUN BITS DIFFER'}", flush=True)
        return {"check": what, "max_abs_err": err, "rel_l2": rel, "ok": ok,
                "bit_identical": same}

    def kinds_of(dtype):
        kinds = [("variant", i, label)
                 for i, (label, _) in enumerate(VARIANTS[dtype])]
        kinds.append(("shim", 0, "port entry point"))
        if "baseline" in libs:
            kinds.append(("baseline", 0, "baseline (--baseline)"))
        return kinds

    # every variant at every check shape, one variant after another: a
    # launch that fails (a trapped wait leaves the context unusable) ends
    # the checks with what they had
    checks = []
    try:
        for dtype in dtypes:
            inputs = {(seq, causal, hd): qkv(CHECK_BH, seq, hd, dtype)
                      for seq in CHECK_SEQS for causal in (True, False)
                      for hd in (32, 64, HD)}
            for kind, var, label in kinds_of(dtype):
                for (seq, causal, hd), (q, k, v) in inputs.items():
                    if kind == "variant" and hd != HD:
                        continue
                    checks.append(check(label, runner(kind, var, q, k, v,
                                                      causal),
                                        q, k, v, causal, dtype))
    except RuntimeError as e:      # also torch's error after a trap
        print(f"[check] FAILED: {e}", flush=True)
        checks.append({"check": str(e), "ok": False, "bit_identical": False})
    bad = [c for c in checks if not (c["ok"] and c["bit_identical"])]
    if any("max_abs_err" not in c for c in bad):
        write(args, card, name, build_s, regs, sass, None, checks, [])
        print(card)
        print("FAIL: a launch failed", file=sys.stderr)
        return 1
    encode_us = None
    if "bf16" in dtypes:
        q, _, _ = qkv(TIME_BH, 77, HD, "bf16")
        encode_us = lib.ab_encode_ns(q.data_ptr(), TIME_BH, 77, 1000) / 1e3
        print(f"[ab] three tensor-map encodes (one wgmma call's): "
              f"{encode_us:.2f} us on the host")
    rows = []
    timer = S.Timer(torch)
    for dtype in dtypes if not bad else ():
        for seq, hd in [(seq, HD) for seq in TIME_SEQS] + list(TIME_RAGGED):
            for causal in (True, False):
                q, k, v = qkv(TIME_BH, seq, hd, dtype)
                pairs = seq * (seq + 1) // 2 if causal else seq * seq
                flops = 4 * TIME_BH * hd * pairs
                bound_us = flops / S.PEAKS[PEAK_KEY[dtype]] * 1e6
                runs = {}
                for kind, var, label in kinds_of(dtype):
                    if kind == "variant" and hd != HD:
                        continue
                    run = runner(kind, var, q, k, v, causal)
                    c = check(label, run, q, k, v, causal, dtype)
                    checks.append(c)
                    if not (c["ok"] and c["bit_identical"]):
                        bad.append(c)
                    runs[label] = (run, c["max_abs_err"])
                runs["sdpa (library)"] = (
                    lambda q=q, k=k, v=v, cz=causal:
                    F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                   is_causal=cz), None)
                times = {label: [] for label in runs}
                for order in (list(runs), list(runs)[::-1]):
                    for label in order:
                        times[label].append(timer(runs[label][0]))
                for label, ts in times.items():
                    us = min(ts) * 1e3
                    rec = {"dtype": dtype, "S": seq, "hd": hd,
                           "causal": causal,
                           "variant": label,
                           "us_rounds": [t * 1e3 for t in ts], "us": us,
                           "TFLOPs": flops / (us * 1e-6) / 1e12,
                           "bound_us": bound_us,
                           "max_abs_err": runs[label][1]}
                    rows.append(rec)
                    print(f"[ab] {dtype} S={seq:4d} hd={hd:3d} "
                          f"{'causal' if causal else 'full  '} {label:30s} "
                          + " / ".join(f"{t:8.1f}" for t in rec["us_rounds"])
                          + f" us ({rec['TFLOPs']:6.1f} TFLOP/s, bound "
                          f"{bound_us:.1f} us)", flush=True)
    write(args, card, name, build_s, regs, sass, encode_us, checks, rows)
    print(card)
    if bad:
        print(f"FAIL: {len(bad)} checks out of tolerance or not "
              "bit-identical", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
