#!/usr/bin/env python3
"""Alternating A/B of the train step's two paths on one rank: the dense
family's sharded path (``make_train_step``'s default for granite-3-2b)
against the gathered path (taken where ``model`` does not divide a
family's tensor-parallel widths, and by every family before the sharded
one existed), step by step on one state.

    python3 scripts/train_step_ab.py [--rounds N] [--steps N] [--layers N]
                                     [--out DIR]

granite-3-2b at its published widths (bf16 params, float32 master,
remat "full"; ``--layers`` cuts the depth) trains at B 8 x S 128 on the
(1, 1) mesh, as ``chip_smoke.py``'s train phase does.  Both steps come
from ``make_train_step``; the gathered one is built with
``factory.shards`` answering False.  On one rank both run the same
ops on the state's own tensors, so the A/B measures what the sharded
path adds on the host.  After one warm-up step each, every round runs
``--steps`` steps of each arm, the order alternating from round to
round, each step timed on the host clock between two synchronisations.
Reports each arm's median step ms, the per-round ratio of the medians
(sharded / gathered) and the rounds in which the sharded arm was the
slower.  Prints the card's name and power limit; details go to
``<out>/train_step_ab.json``.  ``--device cpu --reduced`` rehearses it
on the CPU at the registry's reduced width.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARMS = ("sharded", "gathered")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import factory
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.sharding import partition
    from repro_torch.train import train_step as ts

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    cfg = get_config("granite-3-2b", reduced=args.reduced)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    ocfg = OptConfig()
    mesh = make_local_mesh(device=dev)
    pipe = SyntheticPipeline.for_model(cfg, ShapeConfig("ab", 128, 8,
                                                        "train"),
                                       seed=args.seed, device=dev)
    shapes = ts.init_train_state(cfg, ocfg, device="meta")
    steps = {}
    for arm in ARMS:
        keep = factory.shards
        if arm == "gathered":
            factory.shards = lambda cfg, mesh: False
        try:
            steps[arm], pspecs, bspecs = ts.make_train_step(
                cfg, ocfg, mesh, shapes, pipe.batch_at(0))
        finally:
            factory.shards = keep
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = partition.logical_to_sharding(
        ts.init_train_state(cfg, ocfg, gen, device=dev), pspecs, mesh)
    batch = partition.logical_to_sharding(pipe.batch_at(0), bspecs, mesh)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def run(arm, n):
        nonlocal state
        out = []
        for _ in range(n):
            sync()
            t0 = time.perf_counter()
            state, m = steps[arm](state, batch)
            float(m["loss"])
            sync()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    for arm in ARMS:
        run(arm, 1)
    rounds = []
    for r in range(args.rounds):
        order = ARMS if r % 2 == 0 else ARMS[::-1]
        rec = {"order": list(order)}
        for arm in order:
            rec[arm] = run(arm, args.steps)
        rounds.append(rec)
    med = {arm: statistics.median(x for rd in rounds for x in rd[arm])
           for arm in ARMS}
    ratios = [statistics.median(rd["sharded"]) / statistics.median(
        rd["gathered"]) for rd in rounds]
    slower = sum(x > 1 for x in ratios)
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip().splitlines()[0]
    res = {"card": card, "arch": cfg.name, "layers": cfg.n_layers,
           "rounds": rounds, "median_ms": med, "ratios": ratios,
           "sharded_slower_rounds": slower}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "train_step_ab.json").write_text(json.dumps(res, indent=1))
    print(f"{cfg.name} at {cfg.n_layers} layers, B 8 x S 128, {args.rounds} "
          f"rounds of {args.steps} steps an arm: median step ms sharded "
          f"{med['sharded']:.1f}, gathered {med['gathered']:.1f}; per-round "
          f"ratio sharded / gathered median {statistics.median(ratios):.4f} "
          f"(min {min(ratios):.4f}, max {max(ratios):.4f}); sharded slower "
          f"in {slower} of {len(ratios)} rounds")
    print(card)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
