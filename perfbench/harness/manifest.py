"""``BENCHMARK.json`` and the files it names, found by name:

- a configuration: ``configs/<config>.json``, whose ``family`` names its
  reference ``reference/<family>.py`` and whose ``serving.quant`` names
  its value code ``reference/codes/<quant>.py``;
- a traffic mix: ``traffic/<mix>.json`` (read by ``traffic/generator.py``),
  whose ``loop`` names ``traffic/loops/<loop>.py`` and whose lengths name
  ``traffic/lengths/<dist>.py``;
- a cell's correctness limit and control: ``cells/<workload>.json``;
- a metric's reader: ``metrics/<metric>.py`` with ``read(run)``.

A new cell needs new files of these kinds and an entry in the manifest,
and no edit to any file here.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

from perfbench.harness.plugins import BENCH_DIR, load_module
from perfbench.traffic.generator import load_mix

__all__ = ["BENCH_DIR", "ROOT", "load_manifest", "Cell", "load_reader",
           "NAME_RE", "UNIT_RE"]

ROOT = BENCH_DIR.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no {what} file {path}")
    return json.loads(path.read_text())


class Cell:
    """One workload of the manifest with everything it names loaded."""

    def __init__(self, name: str, manifest: dict | None = None,
                 bench_dir: Path = BENCH_DIR):
        manifest = manifest if manifest is not None else load_manifest(
            bench_dir.parent)
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"have {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = _json(bench_dir.parent / self.config_entry["file"],
                            "configuration")
        self.mix_name = self.entry["traffic"]
        self.mix = load_mix(self.mix_name, bench_dir)
        self.limits = _json(bench_dir / "cells" / f"{name}.json", "cell")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]
        self.bench_dir = bench_dir
        self._load_parts()

    def _load_parts(self) -> None:
        serving = self.config["serving"]
        self.family = load_module("reference", self.config["family"],
                                  self.bench_dir)
        self.codes = (self.code_module(serving["quant"])
                      if serving.get("sparse") and serving.get("quant")
                      not in (None, "none") else None)
        self.loop = load_module("traffic/loops", self.mix["loop"],
                                self.bench_dir).Loop

    def code_module(self, quant: str):
        """The value code ``reference/codes/<quant>.py``."""
        return load_module("reference/codes", quant, self.bench_dir)

    @classmethod
    def from_parts(cls, name: str, config: dict, mix: dict, limits: dict,
                   end_to_end=(), per_layer=(), bench_dir: Path = BENCH_DIR):
        """A cell assembled from loaded parts (the tests' small cells)."""
        cell = cls.__new__(cls)
        cell.name, cell.entry = name, {"name": name, "chips": 1,
                                       "config": config["name"],
                                       "traffic": "test"}
        cell.config_entry = {"name": config["name"]}
        cell.config, cell.mix_name, cell.mix = config, "test", mix
        cell.limits, cell.chips = limits, 1
        cell.end_to_end, cell.per_layer = list(end_to_end), list(per_layer)
        cell.bench_dir = bench_dir
        cell._load_parts()
        return cell

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end


def load_reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return load_module("metrics", metric, bench_dir).read
