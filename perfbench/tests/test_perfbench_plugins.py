"""A new cell is new files and a manifest entry: in a copy of the
benchmark, a new length distribution, an open-loop mix, a new family's
reference, a configuration naming it, a cell's limits and a new metric's
reader are picked up by name, and a whole tiny run on the CPU goes
through them, with no existing file edited."""
from __future__ import annotations

import json
import shutil

import pytest
import torch

from perfbench.harness.cell import run_cell
from perfbench.harness.manifest import BENCH_DIR, Cell, load_manifest
from perfbench.tests._tiny import DATA, TickClock

SEED = 2 ** 33 + 7

FAMILY = '''
"""granite under another name, counting its forward passes."""
from perfbench.reference.granite import *  # noqa: F401,F403
from perfbench.reference import granite as _granite
CALLS = [0]


def forward_logits(*args, **kw):
    CALLS[0] += 1
    return _granite.forward_logits(*args, **kw)
'''

LENGTHS = '''
"""Every length the same: {"dist": "fixed", "value"}."""


def quantiles(spec, n):
    return [int(spec["value"])] * n
'''

READER = '''
"""requests_refused: requests the engine would not take."""


def read(run):
    return len(run.refused) + 0.5
'''


@pytest.fixture()
def new_bench(tmp_path):
    bench = tmp_path / "perfbench"
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "reference" / "granite_twin.py").write_text(FAMILY)
    (bench / "traffic" / "lengths" / "fixed.py").write_text(LENGTHS)
    (bench / "metrics" / "requests_refused.py").write_text(READER)
    config = json.loads((DATA / "tiny-dense-bf16.json").read_text())
    config.update(name="tiny-twin", family="granite_twin")
    (bench / "configs" / "tiny-twin.json").write_text(json.dumps(config))
    mix = json.loads((DATA / "tiny-chat.json").read_text())
    mix.update(loop="open", clients=2, output_len={"dist": "fixed",
                                                    "value": 6},
               arrivals={"rate_per_s": 8.0, "cv": 2.0, "pool": 16})
    (bench / "traffic" / "tiny-open.json").write_text(json.dumps(mix))
    limits = json.loads((DATA / "tiny-cells.json").read_text())
    (bench / "cells" / "tiny-twin.tiny-open.json").write_text(
        json.dumps(limits["tiny-dense-bf16"]))
    man = load_manifest()
    man["configs"].append({"name": "tiny-twin", "source": config["source"],
                           "file": "perfbench/configs/tiny-twin.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "tiny-twin.tiny-open",
                             "config": "tiny-twin", "traffic": "tiny-open",
                             "chips": 1, "why": "a test"})
    man["end_to_end"].append({"name": "requests_refused",
                              "unit": "requests", "better": "lower",
                              "bound": 0.25, "source": "host_clock",
                              "workloads": ["tiny-twin.tiny-open"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    yield bench
    for path, data in before.items():
        assert path.read_bytes() == data, path


def test_a_new_cell_is_new_files_only(new_bench):
    cell = Cell("tiny-twin.tiny-open", bench_dir=new_bench)
    assert cell.family.__name__.startswith("perfbench_reference_granite_twin")
    assert cell.loop.__module__.startswith("perfbench_traffic_loops_open")
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        r = run_cell(cell, SEED, 1.5, False, device="cpu", clock=TickClock(),
                     log=lambda m: None)
    finally:
        torch.set_num_threads(old)
    assert r["correct"], r["check"]
    assert r["metrics"]["requests_refused"]["value"] == 0.5
    assert cell.family.CALLS[0] == r["readings"]["tokens"] // 6 > 0
    assert r["metrics"]["decode_tok_s"]["value"] > 0
