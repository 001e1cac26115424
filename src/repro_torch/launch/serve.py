"""Serving launcher: batched continuous decoding of a registry model with
random weights (mirrors ``src/repro/launch/serve.py``).

``python -m repro_torch.launch.serve --arch granite-3-2b --reduced
    --requests 8 [--device cpu]``

Params come from ``factory.init_params`` with a ``torch.Generator``
seeded 0 on the device; the prompts (4 tokens each) from a second
generator seeded 1.  Runs on CUDA unless ``--device`` names another
device.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.models import factory
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    params = factory.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    eng = ServeEngine(cfg, params, batch_slots=args.slots,
                      max_len=args.max_len, temperature=args.temperature,
                      device=dev)
    rng = torch.Generator().manual_seed(1)
    for rid in range(args.requests):
        prompt = torch.randint(0, cfg.vocab_size, (4,),
                               generator=rng).tolist()
        eng.submit(Request(rid=rid, prompt=prompt,
                           max_new_tokens=args.max_new_tokens))
    t0 = time.time()
    stats = eng.run()
    dt = time.time() - t0
    print(f"completed {stats.requests_completed} requests, "
          f"{stats.tokens_generated} tokens in {dt:.2f}s "
          f"({stats.tokens_generated / max(dt, 1e-9):.1f} tok/s, "
          f"{stats.steps} engine steps)")
    return stats


if __name__ == "__main__":
    main()
