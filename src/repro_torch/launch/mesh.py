"""Device meshes over ``init_device_mesh`` (mirrors
``src/repro/launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
device and starts no process group.  When no process group exists, one
is started from an in-process ``HashStore`` (rank 0 of 1: no network port
is opened for the rendezvous) — NCCL on the card, gloo on the CPU.  A
multi-process launcher starts its group before calling these.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["make_production_mesh", "make_local_mesh"]

_PRODUCTION = {False: ((16, 16), ("data", "model")),
               True: ((2, 16, 16), ("pod", "data", "model"))}


def _process_group(device=None) -> torch.device:
    """The default process group, started as a one-rank group from a
    ``HashStore`` if there is none; returns the mesh's device (``cuda``
    unless named)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dev


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 = 256 ranks (``data``, ``model``); 2 x 16 x 16 = 512 with
    the ``pod`` axis when ``multi_pod``.  Raises unless the process group
    has exactly that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = _PRODUCTION[multi_pod]
    dev = _process_group(device)
    need = 1
    for n in shape:
        need *= n
    have = dist.get_world_size()
    if have != need:
        raise RuntimeError(
            f"the production mesh {dict(zip(axes, shape))} needs {need} "
            f"ranks; this process group has {have}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_local_mesh(model_parallel: int = 1, device=None):
    """Every rank of the process group as (data = world / mp, model =
    mp) with mp = min(model_parallel, world)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = _process_group(device)
    n = dist.get_world_size()
    mp = min(model_parallel, n)
    return init_device_mesh(dev.type, (n // mp, mp),
                            mesh_dim_names=("data", "model"))
