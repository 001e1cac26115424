"""Cells at a size a CPU test run holds: granite-3-2b's smoke sizes (d 128,
2 layers, vocab 512) in bf16, ESPIM int8 and dense, under a 4-client chat
mix; their limits were set from tiny runs of the program and its control
(``data/tiny-cells.json``).  ``TickClock`` stands in for the loop's clock,
so a tiny run's window holds the same ticks however busy the host is."""
from __future__ import annotations

import json
from pathlib import Path

from perfbench.harness.manifest import Cell, load_manifest

DATA = Path(__file__).resolve().parent / "data"
CONFIGS = {"tiny-espim-int8": "tiny-espim-int8.json",
           "tiny-dense-bf16": "tiny-dense-bf16.json"}


def tiny_cell(name: str) -> Cell:
    man = load_manifest()
    config = json.loads((DATA / CONFIGS[name]).read_text())
    mix = json.loads((DATA / "tiny-chat.json").read_text())
    limits = json.loads((DATA / "tiny-cells.json").read_text())[name]
    return Cell.from_parts(name, config, mix, limits, man["end_to_end"],
                           man["per_layer"])


class TickClock:
    """A clock that moves ``step`` seconds each time it is read."""

    def __init__(self, step: float = 0.01):
        self.t, self.step = 0.0, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t
