"""Modules found by name: ``<bench_dir>/<kind>/<name>.py``, loaded from
their file, once a process.

Every part that belongs to one configuration, traffic mix or metric is
such a module, named by a key in a data file: a model family's reference
(``reference/<family>.py``), a value-plane encoding
(``reference/codes/<quant>.py``), a length distribution
(``traffic/lengths/<dist>.py``), a loop (``traffic/loops/<loop>.py``) and
a metric's reader (``metrics/<metric>.py``).  A new one is a new file;
nothing that exists is edited.
"""
from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path

__all__ = ["BENCH_DIR", "load_module"]

BENCH_DIR = Path(__file__).resolve().parents[1]
_LOADED: dict = {}


def load_module(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """The module ``<bench_dir>/<kind>/<name>.py``."""
    path = (Path(bench_dir) / kind / f"{name}.py").resolve()
    mod = _LOADED.get(path)
    if mod is not None:
        return mod
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path} for {name!r}")
    mod_name = "perfbench_" + re.sub(r"\W", "_", f"{kind}/{name}") + \
        f"_{len(_LOADED)}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod     # dataclasses look their module up
    spec.loader.exec_module(mod)
    _LOADED[path] = mod
    return mod
