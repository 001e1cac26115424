#!/usr/bin/env python3
"""Bitwise A/B of the eight hand-written kernels between two checkouts on
one NVIDIA GPU.

    python3 scripts/kernel_bits_ab.py --baseline DIR [--seed N] [--out DIR]

``--baseline`` is another checkout of the repo (say the parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  One worker process per checkout imports that checkout's
``repro_torch``, builds its kernels, and calls each launch wrapper
(``kernels/{espim_spmv, dense_mv, flash_attention}.py``'s ``*_cuda``)
on the same seeded inputs: full-width llama7b-espim shapes (a
4096-row bucket of 8 chunks of 512 columns, 56 slots a chunk, B = 4;
the gate+up form at 8192 rows; W 4096 x 11008; attention at BH 32, hd
128, S 2048 and at hd 80, S 200), fp32, bf16, int8 and int4 planes.
It returns each output's SHA-256 and the launch counts.  Fails unless
every case gives the same bits and the same counts in both checkouts.
Details go to ``<out>/kernel_bits_ab.json``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _cases(torch, seed: int):
    """name -> (wrapper module, wrapper name, args, kwargs)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def cols(r):
        return torch.randint(0, 512, (r, 8, 56), generator=gen, device=dev,
                             dtype=torch.int32)

    def codes(r, lc=56):
        return torch.randint(-127, 128, (r, 8, lc), generator=gen,
                             device=dev, dtype=torch.int8)

    c1, c2 = cols(4096), cols(8192)
    x, x1 = randn(4096, 4), randn(4096)
    nib = torch.randint(0, 256, (4096, 8, 28), generator=gen, device=dev,
                        dtype=torch.uint8)
    kw = {"chunk_cols": 512}
    sp = "espim_spmv"
    return {
        "k5 fp32": (sp, "espim_spmv_cuda", (randn(4096, 8, 56), c1, x1), kw),
        "k5 bf16": (sp, "espim_spmv_cuda",
                    (randn(4096, 8, 56, dtype=torch.bfloat16), c1,
                     x1.to(torch.bfloat16)), kw),
        "k1 fp32": (sp, "espim_spmv_batched_cuda", (randn(4096, 8, 56), c1,
                                                    x), kw),
        "k1 bf16": (sp, "espim_spmv_batched_cuda",
                    (randn(4096, 8, 56, dtype=torch.bfloat16), c1, x), kw),
        "k6 fp32": (sp, "espim_spmv_batched_res_cuda",
                    (randn(4096, 8, 56), c1, x, randn(4096, 4)), kw),
        "k2 int8": (sp, "espim_spmv_batched_quant_cuda",
                    (codes(4096), c1, None, x), kw),
        "k2 int8 scaled": (sp, "espim_spmv_batched_quant_cuda",
                           (codes(4096), c1, randn(4096).abs(), x), kw),
        "k2 int4": (sp, "espim_spmv_batched_quant_cuda", (nib, c1, None, x),
                    kw),
        "k3 fp32": (sp, "espim_spmv_batched_glu_cuda", (randn(8192, 8, 56),
                                                        c2, x), kw),
        "k4 int8": (sp, "espim_spmv_batched_quant_glu_cuda",
                    (codes(8192), c2, randn(8192).abs(), x), kw),
        "k7 fp32": ("dense_mv", "dense_mv_cuda", (randn(4096, 11008),
                                                  randn(11008)), {}),
        "k7 bf16": ("dense_mv", "dense_mv_cuda",
                    (randn(4096, 11008, dtype=torch.bfloat16),
                     randn(11008, dtype=torch.bfloat16)), {}),
        "k8 bf16": ("flash_attention", "flash_attention_cuda",
                    tuple(randn(32, 2048, 128, dtype=torch.bfloat16)
                          for _ in range(3)), {"causal": True}),
        "k8 fp32": ("flash_attention", "flash_attention_cuda",
                    tuple(randn(32, 512, 128) for _ in range(3)),
                    {"causal": False}),
        "k8 bf16 hd80": ("flash_attention", "flash_attention_cuda",
                         tuple(randn(32, 200, 80, dtype=torch.bfloat16)
                               for _ in range(3)), {"causal": True}),
    }


def worker(root: str, seed: int) -> int:
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import importlib

    import torch

    from repro_torch.kernels import build
    build.build_all()
    mods = {m: importlib.import_module(f"repro_torch.kernels.{m}")
            for m in ("espim_spmv", "dense_mv", "flash_attention")}
    for m in mods.values():
        m.reset_launches()
    out = {}
    for name, (mod, fn, args, kw) in _cases(torch, seed).items():
        y = getattr(mods[mod], fn)(*args, **kw)
        torch.cuda.synchronize()
        raw = y.detach().contiguous().view(torch.uint8).cpu().numpy()
        out[name] = {"sha256": hashlib.sha256(raw.tobytes()).hexdigest(),
                     "shape": list(y.shape), "dtype": str(y.dtype)}
    launches = {k: v for m in mods.values() for k, v in m.LAUNCHES.items()}
    print(json.dumps({"cases": out, "launches": launches}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="the other checkout's root")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker, args.seed)
    res = {}
    for label, root in (("baseline", args.baseline), ("this", str(ROOT))):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker", root,
             "--seed", str(args.seed)], capture_output=True, text=True,
            timeout=900)
        if proc.returncode != 0:
            print(f"FAIL: {label} worker: {proc.stderr[-3000:]}",
                  file=sys.stderr)
            return 1
        res[label] = json.loads(proc.stdout.strip().splitlines()[-1])
    base, this = res["baseline"], res["this"]
    same = {k: base["cases"][k] == this["cases"][k] for k in this["cases"]}
    for k, ok in same.items():
        print(f"[bits] {k:16s} {this['cases'][k]['dtype']:15s} "
              f"{'same bits' if ok else 'DIFFERENT'}")
    print(f"[bits] launches baseline {base['launches']}")
    print(f"[bits] launches this     {this['launches']}")
    ok = all(same.values()) and base["launches"] == this["launches"]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "kernel_bits_ab.json").write_text(json.dumps(
        {**res, "same": same, "ok": ok}, indent=1))
    print(f"[bits] {'every case the same bits and counts' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
