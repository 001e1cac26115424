"""What the harness loads: never JAX nor the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference nothing of the port.  And ``run.py`` gives no result without a
card or outside a full checkout."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from perfbench.harness.manifest import BENCH_DIR, ROOT, load_manifest
from perfbench.run import FORBIDDEN, forbidden_modules

READERS = sorted({m["name"] for k in ("end_to_end", "per_layer")
                  for m in load_manifest()[k]})

_LOAD_ALL = """
import json, sys
import perfbench.run as r
r.setup_paths()
import perfbench.calibrate, perfbench.harness.cell, perfbench.harness.provenance
from perfbench.harness.cell import _import_program
from perfbench.harness.manifest import Cell, load_manifest, load_reader
from perfbench.traffic.generator import pool_sizes
_import_program()
for name in json.loads(sys.argv[1]):
    load_reader(name)
for w in load_manifest()["workloads"]:
    pool_sizes(Cell(w["name"]).mix)
print(json.dumps(sorted(sys.modules)))
"""

# every family and value code a configuration names
_LOAD_REFERENCE = """
import json, sys
from pathlib import Path
import perfbench.reference.common, perfbench.reference.espim_pack
from perfbench.harness.plugins import load_module
root = Path(sys.argv[1])
for kind in ("reference", "reference/codes"):
    for path in sorted((root / kind).glob("[!_]*.py")):
        load_module(kind, path.stem)
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str, *args) -> list:
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code, *args], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_forbidden_names_compare_whole_top_levels():
    assert forbidden_modules(["repro_torch", "repro_torch.serve",
                              "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["repro.core", "jax", "jax.numpy", "flax",
                              "jaxlib.xla"]) == ["flax", "jax", "jax.numpy",
                                                 "jaxlib.xla", "repro.core"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "repro"}


def test_the_harness_loads_no_jax():
    mods = _modules(_LOAD_ALL, json.dumps(READERS))
    assert "repro_torch.serve.engine" in mods
    assert forbidden_modules(mods) == []


def test_the_reference_loads_nothing_of_the_port():
    mods = _modules(_LOAD_REFERENCE, str(BENCH_DIR))
    assert any(m.startswith("perfbench_reference_granite") for m in mods)
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def _run_py(cwd, *extra):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         load_manifest()["workloads"][0]["name"], "--seed", "5",
         "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def _no_result(proc) -> bool:
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    return proc.returncode != 0 and not last.startswith("{")


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        return          # on the card a run goes ahead
    assert _no_result(_run_py(ROOT))


def test_bare_benchmark_directory_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert _no_result(_run_py(tmp_path))
