"""Fault-tolerant checkpointing (mirrors ``src/repro/checkpoint/ckpt.py``).

  * **atomicity**: writes go to ``step_NNN.tmp`` and are renamed only after
    the blob and the manifest (with the blob's SHA-256) are fsync'd; a
    crash mid-write never leaves a "latest" checkpoint that is torn;
  * **integrity**: ``restore`` recomputes the SHA-256 and raises on a
    mismatch;
  * **async**: ``save_async`` copies to host memory on the caller's
    thread and writes on a background thread;
  * **keep-k GC**: bounded disk;
  * **exact resume**: the train state and the data-pipeline state are one
    bundle, and resume is bitwise;
  * **reshard**: the blob holds full, unsharded CPU tensors, so
    ``restore(..., mesh, specs)`` places them onto any mesh.

The blob is ``torch.save`` of the state tree (bf16 needs no
``ml_dtypes``), read back with ``weights_only=True``.  The format is the
port's own: it does not read the reference's pickles of numpy arrays.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading

import torch

from repro_torch.sharding.partition import full_value, logical_to_sharding
from repro_torch.tree import tree_map

__all__ = ["save", "save_async", "restore", "latest_step", "list_steps",
           "gc_keep_last"]

_MANIFEST = "manifest.json"
_DATA = "state.pt"


def _to_host(tree):
    """Full CPU tensors: a DTensor's full value, any tensor detached."""
    return tree_map(lambda x: full_value(x).detach().cpu(), tree)


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def _write(path: str, data) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def save(root: str, step: int, state: dict, extra: dict | None = None) -> str:
    """Synchronous atomic save.  ``state`` is a tree of tensors (or
    DTensors); ``extra`` is JSON-serializable metadata (the data-pipeline
    state etc.)."""
    os.makedirs(root, exist_ok=True)
    buf = io.BytesIO()
    torch.save(_to_host(state), buf)
    blob = buf.getbuffer()
    final = _step_dir(root, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    _write(os.path.join(tmp, _DATA), blob)
    manifest = {"step": step, "sha256": hashlib.sha256(blob).hexdigest(),
                "bytes": blob.nbytes, "extra": extra or {}}
    _write(os.path.join(tmp, _MANIFEST), json.dumps(manifest).encode())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_async(root: str, step: int, state: dict,
               extra: dict | None = None) -> threading.Thread:
    """Non-blocking save: copies to host memory on the caller's thread,
    serializes and writes on a daemon thread (returned)."""
    host = _to_host(state)
    t = threading.Thread(target=save, args=(root, step, host, extra),
                         daemon=True)
    t.start()
    return t


def list_steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(root, name, _MANIFEST)):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(root: str) -> int | None:
    steps = list_steps(root)
    return steps[-1] if steps else None


def restore(root: str, step: int | None = None, mesh=None, specs=None):
    """Load a checkpoint and verify its SHA-256 (raises ``IOError`` on a
    mismatch); with ``mesh`` and ``specs`` place it on that mesh
    (``partition.logical_to_sharding``), else CPU tensors.  Returns
    (state, extra, step)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = _step_dir(root, step)
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    with open(os.path.join(d, _DATA), "rb") as f:
        blob = f.read()
    if hashlib.sha256(blob).hexdigest() != manifest["sha256"]:
        raise IOError(f"checkpoint {d} corrupt: sha mismatch")
    state = torch.load(io.BytesIO(blob), weights_only=True)
    if mesh is not None and specs is not None:
        state = logical_to_sharding(state, specs, mesh)
    return state, manifest.get("extra", {}), step


def gc_keep_last(root: str, keep: int = 3) -> None:
    steps = list_steps(root)
    for s in steps[:-keep]:
        shutil.rmtree(_step_dir(root, s), ignore_errors=True)
