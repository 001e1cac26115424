#!/usr/bin/env python3
"""A/B of the WKV kernels' bodies on one NVIDIA GPU, in one process.

    python3 scripts/wkv_ab.py [--seed N] [--out DIR] [--baseline CU]
                              [--rounds N]

Builds ``src/repro_torch/kernels/csrc/wkv.cu`` as it stands and another
``wkv.cu`` (``--baseline``; by default the newest committed one that
differs, from ``git show HEAD:...`` or ``HEAD~1:...`` where git is at
hand; on a copy without git, pass the parent's as a path) into two throwaway
libraries, at once, and calls each through its own C entry points (the
baseline's signature is read from its ``extern "C"`` block: the first
port's forward takes no plan, its backward a ``work`` scratch).

At every ``chip_smoke.WKV_CASES`` shape (rwkv6-1.6b's 32 heads of 64;
inputs as ``chip_smoke._wkv_inputs`` makes them) it checks:

* the forward's final state and its checkpoints (every ``CHUNK`` steps)
  equal the baseline's in bits (both use the instruction pair fmaf(w, S,
  k * v));
* ``y`` and, at the backward's shapes, every gradient (from the same
  checkpoints, ``gy`` and ``gs``) within ``chip_smoke``'s fp32 rule
  (1e-5 max|plain| + 1e-6) against the baseline's and against the plain
  versions (``kernels/ref.wkv6_ref`` / ``wkv6_bwd_ref``);

then times both bodies there with ``chip_smoke.Timer`` (CUDA events
around replays of a captured CUDA graph of ``chip_smoke.WKV_PER_GRAPH``
launches; the forward without checkpoints, as the serving path runs it),
new and baseline in alternating order over
``--rounds`` rounds, beside the bound ``chip_smoke`` computes.  Prints a
table, each build's registers and spills (ptxas) and the card's name and
power limit; details go to ``<out>/wkv_ab.json``.  Exits 1 if a check
fails.
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

CU = ROOT / "src/repro_torch/kernels/csrc/wkv.cu"


def extern_c(source: str) -> dict:
    """{function: number of parameters} of a source's ``extern "C"``
    block."""
    text = re.sub(r"//[^\n]*", "", source)
    block = text.split('extern "C" {', 1)[1]
    return {m.group(1): len(m.group(2).split(","))
            for m in re.finditer(r"\bint\s+(\w+)\s*\(([^)]*)\)\s*\{", block)}


def parent_source() -> Path:
    """The newest committed ``wkv.cu`` that differs from the working
    tree's (HEAD's, else HEAD~1's), written under build/, from git."""
    out = ROOT / "build" / "repro_torch" / "ab" / "wkv_parent.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    rel = CU.relative_to(ROOT).as_posix()
    for rev in ("HEAD", "HEAD~1"):
        text = subprocess.run(["git", "-C", str(ROOT), "show", f"{rev}:{rel}"],
                              capture_output=True, text=True,
                              check=True).stdout
        if text != CU.read_text():
            out.write_text(text)
            return out
    raise RuntimeError("HEAD and HEAD~1 hold this wkv.cu: pass --baseline")


def build_libs(out_dir: Path, baseline: Path):
    """nvcc both sources at once -> ({"new", "baseline": CDLL}, {name:
    nvcc log}, {name: parameter counts}, seconds)."""
    from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {"new": (CU, out_dir / "libwkv_new.so"),
            "baseline": (baseline.resolve(), out_dir / "libwkv_base.so")}
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
    seconds = time.perf_counter() - t0
    P, I = ctypes.c_void_p, ctypes.c_int
    libs, params = {}, {}
    for k, (cu, path) in jobs.items():
        lib = libs[k] = ctypes.CDLL(str(path))
        params[k] = extern_c(cu.read_text())
        for fn, n in params[k].items():
            f = getattr(lib, fn)
            # pointers first, then ints, the stream last
            n_ptr = {"wkv6_fwd": 9, "wkv6_bwd": 15 if n == 23 else 16}[fn]
            f.argtypes = [P] * n_ptr + [I] * (n - n_ptr - 1) + [P]
            f.restype = I
    return libs, logs, params, seconds


def ptxas_summary(log: str) -> list:
    """One line per WKV kernel instance: its mangled name's template part
    and ptxas' register / spill report."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"(wkv6_[a-z]+_kernel(?:I\w*?EE)?)", ln)
        if m and ("Compiling entry" in ln or "Function properties" in ln):
            name = m.group(1)
        elif name and ("registers" in ln or "spill" in ln):
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    ap.add_argument("--baseline", default=None,
                    help="another wkv.cu (default: the parent commit's)")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as S
    from repro_torch.kernels import wkv as WKV
    from repro_torch.kernels.ref import wkv6_bwd_ref, wkv6_ref
    dev = torch.device("cuda")
    name, card = torch.cuda.get_device_name(0), S.nvidia_smi()
    bw = S.card_bandwidth(name)
    base = Path(args.baseline) if args.baseline else parent_source()
    libs, logs, params, build_s = build_libs(
        ROOT / "build" / "repro_torch" / "ab", base)
    print(f"[ab] {name} ({card}); both built in {build_s:.1f} s "
          f"(baseline {base})", flush=True)
    regs = {k: ptxas_summary(v) for k, v in logs.items()}
    for k, lines in regs.items():
        for ln in lines:
            print(f"[ab]   {k}: {ln}")
    f32 = torch.float32

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fwd(kind, ins, chunk):
        r, k, v, w, u, st = WKV._operands(*ins)
        b, s, h, kp = r.shape
        vd = v.shape[-1]
        y = torch.empty((b, s, h, vd), dtype=f32, device=dev)
        s1 = torch.empty((b, h, kp, vd), dtype=f32, device=dev)
        n_ck = -(-s // chunk) if chunk else 0
        ck = torch.empty((b, h, n_ck, kp, vd), dtype=f32, device=dev)
        ptrs = [t.data_ptr() for t in (r, k, v, w, u, st, y, s1, ck)]
        ints = [int(r.dtype == torch.bfloat16), b, s, h, kp, vd, chunk]
        if params[kind]["wkv6_fwd"] > 17:
            plan = WKV._plan(b, h, kp, vd)
            ints += [plan.kg, plan.vs]
        rc = libs[kind].wkv6_fwd(*ptrs, *ints, stream())
        if rc != 0:
            raise RuntimeError(f"{kind} forward: rc {rc}")
        return y, s1, ck

    def bwd(kind, ins, ckpt, gy, gs):
        ops = WKV._operands(*ins[:5], gs)
        r, v = ops[0], ops[2]
        b, s, h, kp = r.shape
        vd = v.shape[-1]
        o = WKV._bwd_buffers(r, v)
        ptrs = [t.data_ptr() for t in ops[:5]] + [ckpt.data_ptr(),
                                                  gy.data_ptr(),
                                                  ops[5].data_ptr()]
        ptrs += [o[n].data_ptr() for n in ("dr", "dk", "dv", "dw", "du",
                                           "ds0", "du_part")]
        if params[kind]["wkv6_bwd"] == 24:          # the first port's work
            ptrs.append(torch.empty((b * h, WKV.CHUNK, vd, kp), dtype=f32,
                                    device=dev).data_ptr())
        rc = libs[kind].wkv6_bwd(*ptrs, int(r.dtype == torch.bfloat16), b,
                                 s, h, kp, vd, WKV.CHUNK, stream())
        if rc != 0:
            raise RuntimeError(f"{kind} backward: rc {rc}")
        return tuple(o[n] for n in ("dr", "dk", "dv", "dw", "du", "ds0"))

    gen = torch.Generator(device=dev).manual_seed(args.seed + 17)
    timer = S.Timer(torch)
    rows, checks, bad = [], [], []
    for label, b, s, dname, backward, kp in S.WKV_CASES:
        dt = torch.bfloat16 if dname == "bf16" else f32
        ins = S._wkv_inputs(torch, gen, dev, b, s, dt, kp)
        got = {k: fwd(k, ins, WKV.CHUNK) for k in ("new", "baseline")}
        torch.cuda.synchronize()
        bits = (torch.equal(got["new"][1], got["baseline"][1])
                and torch.equal(got["new"][2], got["baseline"][2]))
        rec = {"case": label, "B": b, "S": s, "K": kp, "dtype": dname,
               "state_ckpt_bits_equal": bits, "errors": {}}
        if not bits:
            bad.append(f"{label}: s1 / checkpoints differ from the baseline's")
        want_y = wkv6_ref(*ins)[0]
        outs = {"y": (got["new"][0], got["baseline"][0], want_y)}
        if backward:
            gy = torch.randn((b, s, S.WKV_HEADS, S.WKV_HD), generator=gen,
                             device=dev)
            gs = torch.randn(ins[5].shape, generator=gen, device=dev)
            ck = got["new"][2]
            g_new, g_base = bwd("new", ins, ck, gy, gs), \
                bwd("baseline", ins, ck, gy, gs)
            want = wkv6_bwd_ref(*ins, gy, gs)
            for n, a, c, w in zip(("dr", "dk", "dv", "dw", "du", "d_state0"),
                                  g_new, g_base, want):
                outs[n] = (a, c, w)

            def run_new(ins=ins, ck=ck, gy=gy, gs=gs):
                return bwd("new", ins, ck, gy, gs)

            def run_base(ins=ins, ck=ck, gy=gy, gs=gs):
                return bwd("baseline", ins, ck, gy, gs)
            kernel, read = "wkv6_bwd", list(ins[:5]) + [ck, gy, gs]
            written, ops = list(g_new), S.WKV_BWD_OPS
        else:
            def run_new(ins=ins):
                return fwd("new", ins, 0)

            def run_base(ins=ins):
                return fwd("baseline", ins, 0)
            kernel, read = "wkv6", list(ins)
            written, ops = list(got["new"][:2]), S.WKV_FWD_OPS
        for n, (a, c, w) in outs.items():
            ok_p, e_p = S._within(kernel, "fp32", a, w)
            ok_b, e_b = S._within(kernel, "fp32", a, c)
            rec["errors"][n] = {"vs_plain": e_p, "vs_baseline": e_b}
            if not (ok_p and ok_b):
                bad.append(f"{label} {n}: max|new-plain| {e_p:.3e}, "
                           f"max|new-baseline| {e_b:.3e} out of the fp32 rule")
        checks.append(rec)
        times = {"new": [], "baseline": []}
        for i in range(args.rounds):
            order = (("new", run_new), ("baseline", run_base))
            for kind, fn in (order if i % 2 == 0 else order[::-1]):
                times[kind].append(timer(fn, per_graph=S.WKV_PER_GRAPH))
        nbytes = sum(t.numel() * t.element_size() for t in read + written)
        flops = ops * b * s * S.WKV_HEADS * kp * S.WKV_HD
        bound = max(nbytes / bw, flops / S.PEAKS["fp32"]) * 1e6
        us = {k: min(v) * 1e3 for k, v in times.items()}
        row = {"case": label, "kernel": kernel, "B": b, "S": s, "K": kp,
               "dtype": dname, "us": us,
               "us_rounds": {k: [t * 1e3 for t in v]
                             for k, v in times.items()},
               "bound_us": bound, "share_of_bound": bound / us["new"],
               "speedup": us["baseline"] / us["new"]}
        rows.append(row)
        print(f"[ab] {kernel:8s} {label:9s} B {b} x S {s:3d} x K' {kp:2d} "
              f"{dname}: new {us['new']:8.1f} us, baseline "
              f"{us['baseline']:8.1f} us ({row['speedup']:.1f}x), bound "
              f"{bound:6.2f} us ({100 * row['share_of_bound']:.1f}% of it); "
              f"s1 / ckpt bits {'equal' if bits else 'DIFFER'}", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "wkv_ab.json").write_text(json.dumps(
        {"card": card, "device": name, "build_seconds": build_s,
         "baseline": str(base), "ptxas": regs, "checks": checks,
         "rows": rows, "failures": bad}, indent=1))
    print(card)
    if bad:
        for ln in bad:
            print(f"FAIL: {ln}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
