#!/usr/bin/env python3
"""Alternating A/B of the serving engine's end-to-end metrics on one NVIDIA
GPU: this checkout against another, serve by serve.

    python3 scripts/engine_ab.py --baseline DIR [--rounds N] [--seed N]
                                 [--out DIR]

``--baseline`` is another checkout of the repo (say the parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
One worker process per checkout builds that checkout's kernels, makes the
same full-width ``llama7b-espim`` params (2 layers, from ``--seed``) and
int8 packs, and warms up its engines.  Then every round asks the workers
in turn to serve ``chip_smoke.py``'s 8-request trace once with
``chip_smoke.ENGINE_KW``, over three arms: the baseline's int8 sparse
engine, this checkout's, and this checkout's dense bf16 engine
(``sparse=None``, the unpruned params).  The arms' order rotates from
round to round, and reverses every third round, so each arm takes each
position equally often: one process idles while another serves, so a
position effect or a drift of the host clock falls on every arm alike.

Each serve must complete every request, with no quarantine; the two
sparse arms must give the same tokens.  Reports each arm's median tok/s,
TTFT p50 and TPOT p50 over the rounds, and for each pair of arms the
median per-round ratio and the rounds in which the first arm's TPOT was
the higher.  Prints the card's name and power limit; details go to
``<out>/engine_ab.json``.  ``--device cpu --reduced`` rehearses the
protocol on the CPU at the registry's reduced width (no kernel built).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARMS = (("baseline", "sparse"), ("this", "sparse"), ("this", "dense"))
PAIRS = ((("this", "sparse"), ("baseline", "sparse")),
         (("this", "dense"), ("this", "sparse")),
         (("this", "dense"), ("baseline", "sparse")))
METRICS = ("tok_per_s", "ttft_p50_s", "tpot_p50_s")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(args) -> int:
    """Serve on request: one arm name a line on stdin, one JSON line out."""
    proto, sys.stdout = sys.stdout, sys.stderr   # library prints stay off
    sys.path.insert(0, str(Path(args.worker).resolve() / "src"))
    import torch

    cs = _chip_smoke()
    from repro_torch.configs.registry import get_config
    from repro_torch.core.sparse_model import sparsify_model
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import engine as E
    from repro_torch.serve.scheduler import latency_summary
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    cfg = get_config(cs.ARCH, reduced=args.reduced).replace(
        n_layers=cs.N_LAYERS_INT8)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), device=dev)
    engines = {"sparse": E.ServeEngine(
        cfg, params, device=dev, sparse=sparsify_model(
            cfg, params, cfg.espim_sparsity, projections="all",
            quant="int8", device=dev), **cs.ENGINE_KW)}
    if "dense" in args.arms.split(","):
        engines["dense"] = E.ServeEngine(cfg, params, device=dev,
                                         **cs.ENGINE_KW)
    rng = torch.Generator().manual_seed(args.seed + 3)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in cs.PROMPT_LENS]
    for eng in engines.values():                # warm-up, then a full serve
        cs.serve(E, eng, [prompts[0][:3]], 2)
        cs.serve(E, eng, prompts, cs.MAX_NEW)
    print(json.dumps({"ready": sorted(engines)}), file=proto, flush=True)
    for line in sys.stdin:
        arm = line.strip()
        if arm == "quit":
            break
        eng = engines[arm]
        eng.reset_stats()
        reqs, stats, wall = cs.serve(E, eng, prompts, cs.MAX_NEW)
        lat = latency_summary(stats.requests)
        print(json.dumps({
            "wall_s": wall, "tokens": stats.tokens_generated,
            "tok_per_s": stats.tokens_generated / wall,
            "ttft_p50_s": lat["ttft_s"]["p50"],
            "tpot_p50_s": lat["tpot_s"]["p50"],
            "decode_steps": stats.decode_steps,
            "completed": stats.requests_completed,
            "quarantines": getattr(stats, "quarantines", 0),
            "outputs": [r.output for r in reqs]}), file=proto, flush=True)
    return 0


def order(r: int) -> list:
    """Round r's arm order: rotated by r, reversed every third round."""
    k = r % len(ARMS)
    arms = list(ARMS[k:] + ARMS[:k])
    return arms[::-1] if (r // len(ARMS)) % 2 else arms


def run_ab(args) -> int:
    cs = _chip_smoke()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trees = {"baseline": Path(args.baseline).resolve(), "this": ROOT}
    procs = {}
    try:
        for tree, path in trees.items():
            arms = ",".join(a for t, a in ARMS if t == tree)
            cmd = [sys.executable, str(Path(__file__).resolve()),
                   "--worker", str(path), "--arms", arms, "--seed",
                   str(args.seed), "--device", args.device]
            if args.reduced:
                cmd.append("--reduced")
            procs[tree] = subprocess.Popen(
                cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=open(out / f"engine_ab_{tree}.log", "w"), text=True)
        t0 = time.perf_counter()
        for tree, p in procs.items():
            line = p.stdout.readline()
            if not line:
                raise RuntimeError(f"the {tree} worker died before it was "
                                   f"ready; see {out}/engine_ab_{tree}.log")
            print(f"[ab] {tree} worker ready: {line.strip()}", flush=True)
        print(f"[ab] workers ready in {time.perf_counter() - t0:.1f} s",
              flush=True)
        runs = {arm: [] for arm in ARMS}
        for r in range(args.rounds):
            for tree, arm in order(r):
                p = procs[tree]
                p.stdin.write(arm + "\n")
                p.stdin.flush()
                line = p.stdout.readline()
                if not line:
                    raise RuntimeError(f"the {tree} worker died in round {r}")
                rec = json.loads(line)
                n = len(cs.PROMPT_LENS)
                if rec["completed"] != n or rec["quarantines"]:
                    raise RuntimeError(
                        f"{tree} {arm} round {r}: {rec['completed']}/{n} "
                        f"completed, {rec['quarantines']} quarantines")
                rec["position"] = order(r).index((tree, arm))
                runs[(tree, arm)].append(rec)
        for ra, rb in zip(runs[ARMS[0]], runs[ARMS[1]]):
            if ra["outputs"] != rb["outputs"]:
                raise RuntimeError("the two sparse arms gave different tokens")
    finally:
        for p in procs.values():
            if p.poll() is None:
                try:
                    p.stdin.write("quit\n")
                    p.stdin.flush()
                    p.wait(timeout=60)
                except (OSError, subprocess.TimeoutExpired):
                    p.kill()
                    p.wait()

    card = cs.nvidia_smi() if args.device == "cuda" else "cpu"
    report = {"card": card, "rounds": args.rounds, "seed": args.seed,
              "baseline": str(trees["baseline"]), "arms": {}, "pairs": {}}
    print(f"[ab] {card}; {args.rounds} rounds, arms in rotated order")
    for arm, recs in runs.items():
        name = "/".join(arm)
        med = {m: statistics.median(x[m] for x in recs) for m in METRICS}
        report["arms"][name] = {
            **med, "runs": [{k: v for k, v in x.items() if k != "outputs"}
                            for x in recs]}
        print(f"[ab] {name:17s} tok/s {med['tok_per_s']:.1f}, TTFT p50 "
              f"{med['ttft_p50_s'] * 1e3:.2f} ms, TPOT p50 "
              f"{med['tpot_p50_s'] * 1e3:.3f} ms (medians); TPOT min/max "
              f"{min(x['tpot_p50_s'] for x in recs) * 1e3:.3f}/"
              f"{max(x['tpot_p50_s'] for x in recs) * 1e3:.3f} ms")
    for a, b in PAIRS:
        ratio = {m: statistics.median(x[m] / y[m] for x, y in
                                      zip(runs[a], runs[b]))
                 for m in METRICS}
        higher = sum(x["tpot_p50_s"] > y["tpot_p50_s"]
                     for x, y in zip(runs[a], runs[b]))
        name = f"{'/'.join(a)} : {'/'.join(b)}"
        report["pairs"][name] = {**ratio, "tpot_higher_rounds": higher}
        print(f"[ab] {name}: median per-round ratio tok/s "
              f"{ratio['tok_per_s']:.3f}, TTFT {ratio['ttft_p50_s']:.3f}, "
              f"TPOT {ratio['tpot_p50_s']:.3f}; TPOT higher in {higher} of "
              f"{args.rounds} rounds")
    (out / "engine_ab.json").write_text(json.dumps(report, indent=1))
    print(card)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the registry's reduced width (a CPU rehearsal)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--arms", default="sparse", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args)
    if not args.baseline:
        ap.error("--baseline is required")
    return run_ab(args)


if __name__ == "__main__":
    sys.exit(main())
