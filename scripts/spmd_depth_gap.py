#!/usr/bin/env python3
"""The sharded train step's distance from the world-size-1 step at
zamba2's and rwkv6's full reduced depth, beside the world-size-1 step's
own conditioning, on gloo process groups on the CPU.

    python3 scripts/spmd_depth_gap.py [--out FILE]

``tests/test_torch_spmd_train.py`` holds these two families at a cut
depth (zamba2 at 2 of its reduced 6 layers, rwkv6 at 1 of 4 and peak lr
3e-4).  This script runs each family at both depths, at the test's
batch (B 4 x S 16, float32, 3 steps, ``OptConfig(warmup_steps=2,
decay_steps=20)``), on the (2, 2) and (1, 4) meshes (4 processes a
mesh on a ``FileStore``, ~40 s), and reports for each case:

  * ``sharded``: the first step's grads on the shards against the
    world-size-1 step's (max |diff| / max |ref| per leaf, the worst
    leaf over every rank) and every state leaf after 3 steps (|diff| /
    |ref| in L2, ``*/bk`` left out as the test leaves it out), with the
    loss of each step;
  * ``perturbed``: the same two distances between the world-size-1 step
    and itself from initial params scaled elementwise by 1 + 1e-7 u
    (u uniform in [-1, 1]; the worst of three seeds, each seed's worst
    leaf beside it), the optimizer state rebuilt from them: how far
    float32 rounding of the inputs alone carries.

``decode`` does the same for ``tests/test_torch_spmd_decode.py``'s
check: B 4, a 3-token prompt prefilled, then 4 decode steps of
``make_serve_step`` fed the world-size-1 run's greedy tokens; the worst
step's logits and every cache leaf after the steps (max |diff| / max
|ref|), sharded against world size 1 and world size 1 from the
perturbed params against itself.

A fault that only shows with layers stacked would put ``sharded`` far
above ``perturbed``; rounding keeps it at or below.  Prints one JSON
object (and writes it to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3
EPS = 1e-7
SEEDS = (1, 2, 3)                # of the perturbation
MESHES = ((2, 2), (1, 4))        # (data, model)
BATCH, PROMPT, DECODE_STEPS, MAX_LEN = 4, 3, 4, 8
# (arch, n_layers, peak lr): the full reduced depth at the test's lr of
# 1e-3, and the test's own cut
CASES = (("zamba2-2.7b", 6, 1e-3), ("zamba2-2.7b", 2, 1e-3),
         ("rwkv6-1.6b", 4, 1e-3), ("rwkv6-1.6b", 1, 3e-4))


def _worst(errs: dict) -> list:
    """[worst value, its leaf]."""
    leaf = max(errs, key=errs.get)
    return [errs[leaf], leaf]


def _worker(rank: int, world: int, store: str, shape: tuple, out: str):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models import factory, moe
    from repro_torch.optim.adamw import OptConfig, init_opt_state
    from repro_torch.serve.serve_step import make_serve_step, serve_step_fn
    from repro_torch.sharding import partition as PP
    from repro_torch.train import train_step as ts
    from repro_torch.tree import flatten, tree_map

    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))

    def max_rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / max(float(b.double().abs().max()), 1e-30))

    def l2_rel(a, b):
        return float((a.double() - b.double()).norm()
                     / max(float(b.double().norm()), 1e-30))

    def local(tree):
        return tree_map(lambda t: t.to_local(), tree)

    def vs(got, want, err, specs=None):
        """Per leaf: ``got`` (this rank's shards where ``specs``) against
        ``want``'s whole leaves, ``*/bk`` left out of the state."""
        flat_w = dict(flatten(want))
        flat_s = dict(flatten(specs)) if specs is not None else {}
        return {p: err(getattr(t, "to_local", lambda: t)(),
                       PP.local_slice(flat_w[p], flat_s[p], mesh)
                       if specs is not None else flat_w[p])
                for p, t in flatten(got) if not p.endswith("/bk")}

    def perturbed(params, seed):
        gen = torch.Generator().manual_seed(seed)
        return tree_map(lambda t: t * (1 + EPS * (2 * torch.rand(
            t.shape, generator=gen, dtype=torch.float64) - 1)).to(t.dtype),
            params)

    def decode(cfg):
        """{"sharded", "perturbed"}: the worst step's logits and the worst
        cache leaf after the steps, against world size 1."""
        gen = torch.Generator().manual_seed(0)
        params = factory.init_params(cfg, gen, device="cpu")
        prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                               generator=gen, dtype=torch.int32)

        def primed(p):
            cache = factory.init_cache(cfg, BATCH, MAX_LEN, device="cpu")
            return factory.prefill_chunk(cfg, p, cache,
                                         {"tokens": prompt})[1]

        def one_rank(p, toks=None):
            cache, tok, logits, fed = primed(p), prompt[:, -1:], [], []
            for i in range(DECODE_STEPS):
                tok = tok if toks is None else toks[i]
                fed.append(tok)
                nxt, out, cache = serve_step_fn(cfg, p, cache,
                                                {"tokens": tok})
                logits.append(out)
                tok = nxt
            return logits, cache, fed

        def errs(logits, cache, want_l, want_c, specs=None):
            flat_w = dict(flatten(want_c))
            leaves = {p: rel_max(t, flat_w[p], specs and specs[p])
                      for p, t in flatten(cache) if p != "len"}
            return {"logits": max(rel_max(a, b) for a, b in
                                  zip(logits, want_l)),
                    "cache": _worst(merged(leaves))}

        def rel_max(got, want, spec=None):
            got = getattr(got, "to_local", lambda: got)()
            if spec is not None:
                want = PP.local_slice(want, spec, mesh)
            return max_rel(got, want)

        with torch.no_grad():
            want_l, want_c, toks = one_rank(params)
            cache0 = primed(params)
            step, sp, cs, bs = make_serve_step(cfg, mesh, params, cache0,
                                               {"tokens": toks[0]})
            placed_p = PP.logical_to_sharding(params, sp, mesh)
            placed_c = PP.logical_to_sharding(cache0, cs, mesh)
            logits = []
            for tok in toks:
                _, out, placed_c = step(placed_p, placed_c,
                                        PP.logical_to_sharding(
                                            {"tokens": tok}, bs, mesh))
                logits.append(out)
            res = {"sharded": errs(logits, placed_c, want_l, want_c,
                                   dict(flatten(cs)))}
            seeds = []
            for seed in SEEDS:
                got_l, got_c, _ = one_rank(perturbed(params, seed), toks)
                seeds.append(errs(got_l, got_c, want_l, want_c))
        res["perturbed"] = {
            "logits": max(d["logits"] for d in seeds),
            "cache": max((d["cache"] for d in seeds), key=lambda v: v[0])}
        return res

    def merged(errs: dict) -> dict:
        """Each leaf's worst value over the ranks."""
        every = [None] * world
        dist.all_gather_object(every, errs)
        return {p: max(e[p] for e in every) for p in errs}

    res = {}
    for arch, layers, lr in CASES:
        cfg = get_config(arch, reduced=True).replace(n_layers=layers)
        ocfg = OptConfig(warmup_steps=2, decay_steps=20, peak_lr=lr)
        pipe = SyntheticPipeline.for_model(
            cfg, ShapeConfig("t", 16, 4, "train"), device="cpu")
        batches = [pipe.batch_at(i) for i in range(STEPS)]

        def init():
            return ts.init_train_state(cfg, ocfg,
                                       torch.Generator().manual_seed(0),
                                       device="cpu")

        def one_rank(state):
            """(state after the steps, losses, first-step grads)."""
            grads = ts._loss_and_grads(cfg, state["params"], batches[0])[2]
            losses = []
            for b in batches:
                state, m = ts.train_step_fn(cfg, ocfg, state, b)
                losses.append(float(m["loss"]))
            return state, losses, grads

        step, pspecs, bspecs = ts.make_train_step(
            cfg, ocfg, mesh, ts.init_train_state(cfg, ocfg, device="meta"),
            batches[0])
        assert factory.shards(cfg, mesh), (arch, shape)
        placed, losses = PP.logical_to_sharding(init(), pspecs, mesh), []
        for b in batches:
            placed, m = step(placed, PP.logical_to_sharding(b, bspecs, mesh))
            losses.append(float(m["loss"]))
        state0 = PP.logical_to_sharding(init(), pspecs, mesh)
        pb0 = PP.logical_to_sharding(batches[0], bspecs, mesh)
        _, _, g = ts._loss_and_grads(
            cfg, local(state0["params"]), local(pb0), 1, None,
            PP.Layout.of(state0["params"]), moe.Split(mesh,
                                                      bspecs["tokens"][0]),
            PP.Layout.of(pb0))

        plain, want, g1 = one_rank(init())
        case = {"sharded": {
            "grads": _worst(merged(vs(g, g1, max_rel, pspecs["params"]))),
            "state": _worst(merged(vs(placed, plain, l2_rel, pspecs))),
            "loss": [abs(a - b) / abs(b) for a, b in zip(losses, want)]}}

        seeds = []
        for seed in SEEDS:
            params = perturbed(init()["params"], seed)
            other, got, g2 = one_rank({"params": params,
                                       "opt": init_opt_state(ocfg, params)})
            seeds.append({
                "grads": _worst(vs(g2, g1, max_rel)),
                "state": _worst(vs(other, plain, l2_rel)),
                "loss": [abs(a - b) / abs(b) for a, b in zip(got, want)]})
        case["perturbed"] = {
            k: max((d[k] for d in seeds), key=lambda v: v[0])
            for k in ("grads", "state")}
        case["perturbed"]["seeds"] = seeds
        case["decode"] = decode(cfg)
        res[f"{arch}|{layers}|{lr:g}"] = case
    if rank == 0:
        Path(out).write_text(json.dumps(res))
    dist.destroy_process_group()


def _mesh(text: str) -> tuple:
    return tuple(int(n) for n in text.split("x"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", nargs=5, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        rank, world, store, shape, out = args.worker
        _worker(int(rank), int(world), store, _mesh(shape), out)
        return 0
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for shape in MESHES:
            tag = "x".join(map(str, shape))
            world = shape[0] * shape[1]
            out = os.path.join(tmp, f"{tag}.json")
            env = dict(os.environ, OMP_NUM_THREADS="1")
            procs = [subprocess.Popen(
                [sys.executable, __file__, "--worker", str(r), str(world),
                 os.path.join(tmp, f"store_{tag}"), tag, out], env=env)
                for r in range(world)]
            codes = [p.wait() for p in procs]
            if any(codes):
                print(f"FAIL: mesh {tag} exited {codes}", file=sys.stderr)
                return 1
            res[tag] = json.loads(Path(out).read_text())
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        args.out.write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
