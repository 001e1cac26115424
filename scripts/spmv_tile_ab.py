#!/usr/bin/env python3
"""A/B of the batched SpMV ring body on one NVIDIA GPU, in one process.

    python3 scripts/spmv_tile_ab.py [--seed N] [--out DIR] [--baseline CU]

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

Each variant is checked against the plain version first (grouped: the
grouped plain version; per bucket: the bucket's).  Timing is
``chip_smoke.Timer`` (CUDA events around replays of a captured CUDA
graph); the variants are timed in turns, in order and then in reverse,
and both rounds are reported.  At B = 4 each variant's launches are also
timed one by one, as ``chip_smoke`` times its buckets (``bucket_times``:
a graph of an L2-evicting read and the launch, less the read).  Prints a
table, the card's name and power limit; details go to
``<out>/spmv_tile_ab.json``.
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
    for k, (cu, path) in jobs.items():
        lib = libs[k] = ctypes.CDLL(str(path))
        sched = k == "shim" or takes_schedule(cu)
        fns = ENTRY_POINTS + (("espim_spmv_group",) if k == "shim" else ())
        for fn in fns:
            argtypes = _SIGNATURES["espim_spmv"][fn]
            # without the schedule: the same less (wpr, u) before stream
            getattr(lib, fn).argtypes = (argtypes if sched else
                                         argtypes[:-3] + argtypes[-1:])
            getattr(lib, fn).restype = I
    shim = libs["shim"]
    shim.ab_group.argtypes = [I, I, I, I] + [P] * 7 + [I] * 5 + [P]
    shim.ab_group.restype = I
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
    base_sched = (DEFAULT_SCHED if args.baseline
                  and takes_schedule(Path(args.baseline)) else ())
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
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
