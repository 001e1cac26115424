"""Build and bind the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (``SOURCES``: one library per
source; ``build_all`` starts one ``nvcc`` per source at once), at first
use, under
``build/repro_torch/`` at the repository root.  The library's file name
carries a hash of the source and the flags, so an edited source is rebuilt
and a stale library is never loaded.  It is loaded with ``ctypes``; every
pointer and the stream travel as ``c_void_p``.

Nothing here runs at import: the CPU tests import every module, and the
build happens inside the first call that launches a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "build_dir", "library_path",
           "find_nvcc", "build", "build_all", "load_library", "BUILD_LOG"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"espim_spmv": _CSRC / "espim_spmv.cu",
           "dense_mv": _CSRC / "dense_mv.cu",
           "flash_attention": _CSRC / "flash_attention.cu",
           "wkv": _CSRC / "wkv.cu",
           "decode_attention": _CSRC / "decode_attention.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# per-library build record: {name: {"path", "seconds", "cached", "log"}}
BUILD_LOG: dict = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points (csrc/<library>.cu)
_SIGNATURES = {
    "espim_spmv": {
        "espim_spmv": [_P, _I, _P, _P, _I, _P] + [_I] * 13 + [_P],
        "espim_spmv_batched_res_fp": [_P, _I, _P, _P, _P, _P, _I, _I, _I,
                                      _I, _I, _I, _I, _I, _P],
        "espim_spmv_batched_fp": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _P],
        "espim_spmv_batched_quant": [_P, _I, _I, _P, _P, _I, _P, _P, _I, _I,
                                     _I, _I, _I, _I, _I, _I, _P],
        "espim_spmv_batched_glu_fp": [_P, _I, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _I, _I, _I, _I, _P],
        "espim_spmv_batched_quant_glu": [_P, _I, _I, _P, _P, _P, _P, _I, _I,
                                         _I, _I, _I, _I, _I, _I, _I, _P],
        "espim_spmv_group": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _P],
    },
    "dense_mv": {
        "dense_mv": [_P, _I, _P, _I, _P, _I, _I, _I, _P],
    },
    "flash_attention": {
        "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    },
    "wkv": {
        "wkv6_fwd": [_P] * 9 + [_I] * 9 + [_P],
        "wkv6_bwd": [_P] * 15 + [_I] * 7 + [_P],
    },
    "decode_attention": {
        "decode_attention": [_P] * 7 + [_I] * 7 + [_F, _I, _F, _P],
    },
}
_LIBS: dict = {}


def build_dir() -> Path:
    """``build/repro_torch`` under the repository root (src/..)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def library_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (Path(home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built at first use")


def build_all(names=None) -> dict:
    """Compile every named source (default: all) whose hashed library does
    not exist yet, one ``nvcc`` per source, all started together; returns
    {name: library path}.  Each writes to a temporary name and renames,
    so concurrent processes never load a half-written library; nvcc's
    report (ptxas' registers and spills) is kept beside it as
    ``<library>.log`` for a later process that finds it built.  Raises
    with nvcc's output if any build fails."""
    names = list(SOURCES if names is None else names)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            report = out.with_suffix(".log")
            BUILD_LOG.setdefault(name, {
                "path": str(out), "seconds": 0.0, "cached": True,
                "log": report.read_text() if report.exists() else ""})
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True),
                         tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {SOURCES[name]} "
                          f"(rc {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        BUILD_LOG[name] = {"path": str(out), "cached": False, "log": log,
                           "seconds": time.perf_counter() - t0}
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def build(name: str) -> Path:
    """Compile one source unless its hashed library already exists."""
    return build_all([name])[name]


def load_library(name: str = "espim_spmv") -> ctypes.CDLL:
    """The built library with every entry point's argtypes set."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
