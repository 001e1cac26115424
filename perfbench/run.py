"""Run one cell of ``BENCHMARK.json`` once on this machine's card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run it from the root of a checkout.  It prints its provenance first, the
numbers the check compared beside their limits as the last lines of
standard error, and one JSON result as the last line of standard output:
with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics.  It exits non-zero, printing no result, without enough
CUDA cards, or when JAX, jaxlib, flax or the JAX package (``repro``) got
loaded.  Every build and kernel cache stays under ``build/`` in the
checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# caches a library may write, each at a fixed path inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/triton",
              "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "CUDA_CACHE_PATH": "build/cuda_cache",
              "TORCHINDUCTOR_CACHE_DIR": "build/inductor"}


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def setup_paths() -> None:
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    args = parse(argv)
    setup_paths()
    import torch

    from perfbench.harness import provenance
    from perfbench.harness.cell import run_cell
    from perfbench.harness.manifest import Cell

    cell = Cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: this benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, torch.get_num_threads()))
    for line in provenance.lines(torch, cell):
        print(line, flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START,
                      log=lambda m: print(m, file=sys.stderr, flush=True))
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
