"""The readings a cell's correctness limit is set from, in one process.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,... \\
        [--control-seeds 7,8,9] --seconds <s> [--out <file.jsonl>]

For every seed of ``--seeds`` it runs the cell as the benchmark does (a
short window) and records the reading of the number ``correct``
compares, the widest logit gap of the served tokens: the program's lower
readings.  On each of ``--control-seeds`` it runs the cell's control in
the program's place (``cells/<workload>.json``, ``control``), through the
same check, for the upper readings, and records whether ``correct`` came
out false:

- ``program_quant``: the program serving that lower value code, held to
  the configuration's reference;
- ``reference_code``: the reference with its weights so coded, whose best
  token at each served position stands in for the served one (such a run
  also records the program's own reading beside it).

Each run prints one JSON line (to ``--out`` too).  The benchmark's own
runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

from perfbench.run import setup_paths  # noqa: E402

__all__ = ["calibrate"]


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s.strip()]


def calibrate(cell, seeds, control_seeds, seconds: float, device: str,
              emit) -> None:
    from perfbench.harness.cell import run_cell
    quiet = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    runs = [(s, False) for s in seeds] + [(s, True) for s in control_seeds]
    for seed, control in runs:
        t0 = time.perf_counter()
        r = run_cell(cell, seed, seconds, False, device=device,
                     control=control, log=quiet)
        emit({"workload": cell.name, "seed": seed,
              "kind": "control" if control else "program",
              "control": cell.limits["control"] if control else None,
              "correct": r["correct"], "check": r["check"],
              "readings": r["readings"], "failed": r["failed"],
              "attempted": r["attempted"], "metrics": r["metrics"],
              "seconds": time.perf_counter() - t0})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    setup_paths()
    from perfbench.harness.manifest import Cell
    cell = Cell(args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    try:
        calibrate(cell, _seeds(args.seeds), _seeds(args.control_seeds),
                  args.seconds, args.device, emit)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
