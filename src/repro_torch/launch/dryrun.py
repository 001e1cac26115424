"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake
process group of 256 or 512 ranks, with no card and no memory (mirrors
``src/repro/launch/dryrun.py``, which lowers and compiles the cells on
512 fake XLA host devices).

One process starts a ``"fake"`` process group of the production mesh's
rank count (``launch/mesh.make_production_mesh``: 16 x 16, or 2 x 16 x
16 with the pod axis), builds the cell's inputs from ``launch/specs`` as
fake DTensors holding this rank's shards under the port's ``partition``
rules, and runs the cell's entry point once under ``FakeTensorMode``
(``train_step.make_train_step``; for prefill
``factory.apply_train_sharded`` under no_grad on the ``param_pspecs``
shards where ``factory.shards`` (every family, where ``model`` divides
its tensor-parallel widths), else ``factory.apply_train`` on the
gathered params; ``serve_step.make_serve_step``), with the cost analysis
(``launch/cost_analysis.py``) and a memory tracker.  Decode cells take
the int8 KV cache for every family but ssm, as the reference's.  Each
cell writes the reference's record: ``memory`` (the inputs' local shards
``argument_size_in_bytes``, the outputs' ``output_size_in_bytes``, the
peak less the inputs ``temp_size_in_bytes``), ``hlo_cost`` (the
``StepCost`` dict, under the reference's key), ``status`` and
``trace_s`` (in place of ``lower_s`` / ``compile_s``), and ``fits_card``:
the per-device peak against the H100's 80 GB.

The fake tensors live on ``cuda``, so the step reaches the hand-written
kernels' ops as it does on the card (their Meta implementations; no
launch).  A CPU-only PyTorch can make fake ``cuda`` tensors but cannot
index them from Python (the indexing binding takes a CUDA device guard)
nor differentiate them (autograd's engine does too): there, prefill and
decode cells index through ``_CudaIndexing`` and train cells run on
fake ``cpu`` tensors, which take the same ops (under grad only the WKV
ops run a kernel, and its dispatch sends any fake tensor to them).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
      --shape train_4k --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --summary
Results are cached as JSON under experiments/dryrun_torch/.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.registry import ASSIGNED, get_config, skip_reason
from repro_torch.launch import specs as S
from repro_torch.launch.cost_analysis import CostMode
from repro_torch.models import factory, moe
from repro_torch.optim.adamw import OptConfig
from repro_torch.serve import serve_step
from repro_torch.sharding import partition
from repro_torch.train import train_step as ts
from repro_torch.tree import leaves, tree_map

__all__ = ["run_cell", "run", "cell_path", "main", "CARD_BYTES",
           "MESHES", "fake_group", "place", "local_bytes"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
CARD_BYTES = 80 * 10 ** 9               # the H100's 80 GB of HBM3
MESHES = {"single": (16, 16), "multi": (2, 16, 16)}
_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


@contextlib.contextmanager
def fake_group(world: int):
    """A ``"fake"`` default process group of ``world`` ranks (this
    process is rank 0), destroyed on exit.  Raises when this PyTorch has
    no fake process group, or when the process already has a group."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch.testing._internal.distributed.fake_pg "
            "(a fake process group); this PyTorch has none") from e
    if dist.is_initialized():
        raise RuntimeError(
            "the dry run starts a fake process group of its own, and this "
            "process already has one: run it in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _slicing(t: torch.Tensor, idx) -> tuple:
    """Python indexing as aten ops, as the indexing binding applies it:
    ints select, slices slice, None unsqueezes, Ellipsis skips; tensor
    (and list) indices are gathered for one ``aten.index``.  Returns
    (the basic view, the tensor indices by dim)."""
    items = idx if isinstance(idx, tuple) else (idx,)
    given = sum(it.dim() if isinstance(it, torch.Tensor)
                and it.dtype == torch.bool else 1
                for it in items if it is not None and it is not Ellipsis)
    res, dim, tix = t, 0, []
    for it in items:
        if it is Ellipsis:
            dim += t.dim() - given
        elif it is None:
            res = res.unsqueeze(dim)
            dim += 1
        elif isinstance(it, int) and not isinstance(it, bool):
            res = res.select(dim, it)
        elif isinstance(it, slice):
            if it != slice(None):
                res = torch.ops.aten.slice.Tensor(
                    res, dim, it.start, it.stop,
                    1 if it.step is None else it.step)
            dim += 1
        else:
            if not isinstance(it, torch.Tensor):
                it = torch.tensor(it, device=t.device)
            tix += [None] * (dim - len(tix)) + [it]
            dim += it.dim() if it.dtype == torch.bool else 1
    return res, tix


def _to(t: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """``Tensor.to`` as ``aten._to_copy`` (or ``t`` when nothing
    changes)."""
    device, dtype, _, fmt = torch._C._nn._parse_to(*args, **kwargs)
    device = t.device if device is None else torch.device(device)
    dtype = t.dtype if dtype is None else dtype
    if (device.type == t.device.type and dtype == t.dtype
            and fmt in (None, torch.preserve_format)):
        return t
    return torch.ops.aten._to_copy.default(t, dtype=dtype, device=device)


class _CudaIndexing(TorchFunctionMode):
    """``Tensor.__getitem__`` / ``__setitem__`` / ``to`` / ``contiguous`` /
    ``copy_`` through aten ops, for fake ``cuda`` tensors on a CPU-only PyTorch
    (whose Python bindings of these take a CUDA device guard it was not
    built with)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.to:
            return _to(*args, **(kwargs or {}))
        if func is torch.Tensor.copy_:
            return torch.ops.aten.copy_.default(*args, **(kwargs or {}))
        if func is torch.Tensor.contiguous:
            t = args[0]
            return t if t.is_contiguous() else torch.ops.aten.clone.default(
                t, memory_format=torch.contiguous_format)
        if func is torch.Tensor.__getitem__:
            res, tix = _slicing(*args)
            if tix:
                return torch.ops.aten.index.Tensor(res, tix)
            return res.alias() if res is args[0] else res
        if func is torch.Tensor.__setitem__:
            t, idx, val = args
            res, tix = _slicing(t, idx)
            aten = torch.ops.aten
            if not isinstance(val, torch.Tensor):
                val = aten.full.default((), val, dtype=t.dtype,
                                        device=t.device)
            if tix:
                aten.index_put_.default(res, tix, val)
            else:
                aten.copy_.default(res, val)
            return None
        return func(*args, **(kwargs or {}))


def _device(kind: str) -> tuple[str, bool]:
    """(the fake tensors' device, whether indexing needs
    ``_CudaIndexing``) for a cell of ``kind`` on this PyTorch."""
    if torch.backends.cuda.is_built():
        return "cuda", False
    return ("cpu", False) if kind == "train" else ("cuda", True)


def place(tree, specs, mesh, device: str):
    """Fake DTensors of ``tree``'s shapes and dtypes (meta leaves) placed
    by ``specs`` on ``mesh``: each rank's local shard, made directly (no
    scatter from a source rank).  Call under ``FakeTensorMode``."""
    from torch.distributed.tensor import DTensor

    def one(leaf, spec):
        placements = partition.named(mesh, spec)
        shape = list(leaf.shape)
        for i, p in enumerate(placements):
            if p.is_shard():
                shape[p.dim] //= mesh.size(i)
        local = torch.empty(shape, dtype=leaf.dtype, device=device)
        return DTensor.from_local(local, mesh, placements, run_check=False)

    return tree_map(one, tree, specs)


def local_bytes(tree) -> int:
    """Bytes of a tree's tensors on this rank (a DTensor's local shard),
    each storage once."""
    seen, total = set(), 0
    for t in leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        t = t.to_local() if hasattr(t, "to_local") else t
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


def _entry(cfg: ModelConfig, shape: ShapeConfig, mesh, ocfg: OptConfig,
           sp: dict) -> tuple:
    """(step, args' meta trees, args' specs) of the cell's entry point."""
    if shape.kind == "train":
        step, pspecs, bspecs = ts.make_train_step(cfg, ocfg, mesh,
                                                  sp["state"], sp["batch"])
        return step, (sp["state"], sp["batch"]), (pspecs, bspecs)
    bspecs = partition.batch_pspecs(sp["batch"], mesh)
    if shape.kind == "prefill":
        split = moe.Split(mesh, bspecs["tokens"][0])

        @torch.no_grad()
        def prefill(params, batch):
            local = tree_map(lambda t: t.to_local(), batch)
            if factory.shards(cfg, mesh):
                # this rank's logits (its batch, its vocab shard)
                return factory.apply_train_sharded(
                    cfg, tree_map(lambda t: t.to_local(), params), local,
                    partition.Layout.of(params), split)[0]
            return factory.apply_train(
                cfg, tree_map(partition.full_value, params), local,
                split)[0]

        pspecs = partition.param_pspecs(sp["params"], mesh)
        return prefill, (sp["params"], sp["batch"]), (pspecs, bspecs)
    step, _, cspecs, _ = serve_step.make_serve_step(
        cfg, mesh, sp["params"], sp["cache"], sp["batch"])
    # the reference's in_shardings: at global_batch 1 the contraction dim
    # also shards over 'data'
    pspecs = partition.serve_param_pspecs(sp["params"], mesh,
                                          global_batch=shape.global_batch)
    return (step, (sp["params"], sp["cache"], sp["batch"]),
            (pspecs, cspecs, bspecs))


def run(cfg: ModelConfig, shape: ShapeConfig, mesh_shape: tuple,
        ocfg: OptConfig | None = None, inputs_only: bool = False) -> dict:
    """Trace one step of ``cfg`` at ``shape`` on a fake group of
    prod(mesh_shape) ranks ((data, model) or (pod, data, model)); the
    record without the cell's names.  With ``inputs_only`` only the
    inputs are placed (their per-device bytes) and no step runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.device_mesh import init_device_mesh

    if shape.kind == "decode" and cfg.family != "ssm":
        # serving deployment default, as the reference's dry run
        cfg = cfg.replace(kv_cache_dtype="int8")
    ocfg = ocfg or OptConfig()
    device, shim = _device(shape.kind)
    sp = S.input_specs(cfg, shape, ocfg)
    world = math.prod(mesh_shape)
    with fake_group(world):
        mesh = init_device_mesh(device, tuple(mesh_shape),
                                mesh_dim_names=_AXES[len(mesh_shape)])
        step, trees, specs = _entry(cfg, shape, mesh, ocfg, sp)
        with FakeTensorMode(allow_non_fake_inputs=True):
            args = [place(t, s, mesh, device) for t, s in zip(trees, specs)]
            arg_bytes = local_bytes(args)
            rec = {"mesh_shape": list(mesh_shape), "n_devices": world,
                   "device": device,
                   "memory": {"argument_size_in_bytes": arg_bytes}}
            if inputs_only:
                return rec
            tracker = MemTracker()
            tracker.track_external(*[t.to_local() for t in leaves(args)])
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                if shim:
                    stack.enter_context(_CudaIndexing())
                cost = stack.enter_context(CostMode()).cost
                stack.enter_context(tracker)
                out = step(*args)
            trace_s = time.perf_counter() - t0
            peak = sum(v["Total"] for v in
                       tracker.get_tracker_snapshot("peak").values())
            out_bytes = local_bytes(list(out) if isinstance(out, tuple)
                                    else out)
    rec.update({
        "status": "ok", "trace_s": trace_s, "hlo_cost": cost.as_dict(),
        "fits_card": peak <= CARD_BYTES, "card_bytes": CARD_BYTES})
    rec["memory"].update({"output_size_in_bytes": out_bytes,
                          "temp_size_in_bytes": peak - arg_bytes,
                          "peak_size_in_bytes": peak})
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             ocfg: OptConfig | None = None, verbose: bool = True, *,
             reduced: bool = False, mesh_shape: tuple | None = None,
             shape: ShapeConfig | None = None,
             inputs_only: bool = False) -> dict:
    """One registry cell on the production mesh (16 x 16, or 2 x 16 x 16
    when ``multi_pod``); small checks name a ``mesh_shape``, ``reduced``
    configs and a ``shape`` of their own."""
    cfg = get_config(arch, reduced=reduced)
    shape = shape or SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    reason = skip_reason(cfg, shape)
    if reason:
        return {**head, "status": "skipped", "reason": reason}
    rec = {**head, **run(cfg, shape, mesh_shape or MESHES[mesh_name], ocfg,
                         inputs_only)}
    if verbose and not inputs_only:
        h, m = rec["hlo_cost"], rec["memory"]
        print(f"[{arch} x {shape_name} x {mesh_name}] OK "
              f"trace={rec['trace_s']:.1f}s "
              f"dotflops/dev={h['dot_flops']:.3g} "
              f"dotbytes/dev={h['dot_bytes']:.3g} "
              f"coll/dev={h['collective_total_bytes']:.3g}B "
              f"args={m['argument_size_in_bytes'] / 2**30:.2f}GiB "
              f"peak={m['peak_size_in_bytes'] / 2**30:.2f}GiB "
              f"fits_card={rec['fits_card']}", flush=True)
    return rec


def cell_path(arch, shape_name, mesh_name):
    return os.path.join(OUT_DIR, f"{arch}__{shape_name}__{mesh_name}.json")


def summary() -> str:
    """A markdown table of the records under ``OUT_DIR``, one row per
    (arch, shape) with the 16 x 16 and the 2 x 16 x 16 mesh's values as
    "single / multi": per device, argument and peak GB, TFLOP, collective
    GB, ``fits_card``, and the seconds the trace took."""
    recs = {}
    for name in sorted(os.listdir(OUT_DIR)) if os.path.isdir(OUT_DIR) else ():
        with open(os.path.join(OUT_DIR, name)) as f:
            r = json.load(f)
        recs.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r

    def both(cell, fn):
        return " / ".join(fn(cell[m]) if cell.get(m, {}).get("status") == "ok"
                          else cell.get(m, {}).get("status", "-")
                          for m in ("single", "multi"))

    rows = ["| arch | shape | args GB | peak GB | TFLOP | collective GB | "
            "fits_card | trace s |", "|---|---|---|---|---|---|---|---|"]
    for (arch, shape), cell in sorted(recs.items()):
        rows.append(" | ".join([
            f"| {arch}", shape,
            both(cell, lambda r: f"{r['memory']['argument_size_in_bytes'] / 1e9:.3f}"),
            both(cell, lambda r: f"{r['memory']['peak_size_in_bytes'] / 1e9:.1f}"),
            both(cell, lambda r: f"{r['hlo_cost']['flops'] / 1e12:.1f}"),
            both(cell, lambda r: f"{r['hlo_cost']['collective_total_bytes'] / 1e9:.2f}"),
            both(cell, lambda r: str(r["fits_card"])),
            both(cell, lambda r: f"{r['trace_s']:.0f}")]) + " |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--summary", action="store_true",
                    help="print the table of the records written so far")
    args = ap.parse_args(argv)
    if args.summary:
        print(summary())
        return

    os.makedirs(OUT_DIR, exist_ok=True)
    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for arch in archs:
        for shape_name in shapes:
            for mesh_name in meshes:
                path = cell_path(arch, shape_name, mesh_name)
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[{arch} x {shape_name} x {mesh_name}] cached "
                              f"({prev['status']})")
                        continue
                try:
                    res = run_cell(arch, shape_name, mesh_name == "multi")
                except Exception as e:  # noqa: BLE001 - report, keep sweeping
                    res = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    failures.append((arch, shape_name, mesh_name, str(e)))
                    print(f"[{arch} x {shape_name} x {mesh_name}] FAILED: "
                          f"{type(e).__name__}: {str(e)[:300]}")
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f4 in failures:
            print("  ", f4[:3], f4[3][:150])
        raise SystemExit(1)
    print("\nAll requested dry-run cells passed.")


if __name__ == "__main__":
    main()
