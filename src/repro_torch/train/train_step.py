"""The training step: loss -> grads (with microbatch accumulation) -> the
optional int8 error-feedback compression -> clip -> AdamW, and the same
step on a device mesh (mirrors ``src/repro/train/train_step.py``).

``train_step_fn`` runs on plain tensors: autograd over ``factory.loss_fn``
in place of ``jax.value_and_grad``, then ``apply_updates`` in place (the
reference's donated buffers).  The remat policy comes from the model
config (``transformer.remat_wrap``).

``make_train_step`` gives the step on DTensors placed by the partition
rules, with the reference's SPMD meaning: the step equals the unsharded
step on the global batch.  Which path it runs depends on the mesh:

  * Where ``factory.shards`` (every family, on a mesh whose ``model``
    axis divides the family's tensor-parallel widths) the state stays
    at its shards for the whole step, the layout the reference's
    partitioner gives: each rank runs ``factory.loss_fn`` on its local
    tensors and its part of the batch (``factory.apply_train_sharded``:
    ZeRO-3 on ``data`` with a per-layer all-gather whose backward
    reduce-scatters the grads as their mean over the data-parallel
    axes, tensor parallelism on ``model``, expert parallelism on
    ``model`` for MoE, the Mamba2 mixer and the RWKV time mix on a
    rank's heads, a vocab-parallel cross-entropy); the compression and
    AdamW run on the local shards, the global norm and the compression's
    scales all-reduced over the axes that split each leaf.  A rank
    holds its shards plus one layer's params gathered along ``data``.
  * Elsewhere every leaf is gathered to its full value on every rank,
    the step runs there on the rank's part of the batch with the loss,
    metrics and grads averaged over the data-parallel axes, and the
    shards are copied back.

On both paths the MoE family's dispatch groups are the global batch's
(``moe.Split``: the batch axes of the batch's spec), as the reference's
under ``jit``, and so are the microbatches: microbatch i is the global
rows [i·B/n, (i+1)·B/n), of which each rank takes its part along the
major batch axes that divide B/n and all of it along the rest
(``microbatch_axes``, ``_split_microbatches``): a microbatch of fewer
rows than the data ranks runs whole on each of them.

A leaf whose sharded mesh dims have size 1 is its DTensor's local tensor,
so at world size 1 both paths are ``train_step_fn`` on the state's own
tensors, bit for bit, with no copy and no collective.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import factory, moe
from repro_torch.optim import compression
from repro_torch.optim.adamw import OptConfig, apply_updates, init_opt_state
from repro_torch.sharding import partition
from repro_torch.tree import flatten, map_with_path, tree_map

__all__ = ["make_train_step", "init_train_state", "train_step_fn",
           "param_state_pspecs", "microbatch_axes"]


def init_train_state(cfg: ModelConfig, ocfg: OptConfig, generator=None,
                     compress_grads: bool = False, device=None) -> dict:
    """{"params", "opt"[, "ef_error"]}: params from ``factory.init_params``
    (``device="meta"`` gives the shapes without memory)."""
    params = factory.init_params(cfg, generator, device)
    state = {"params": params, "opt": init_opt_state(ocfg, params)}
    if compress_grads:
        state["ef_error"] = compression.init_error_state(params)
    return state


def microbatch_axes(batch: dict, n: int, layout):
    """The spec entry of each of ``n`` microbatches' batch dim, for this
    rank's part ``batch`` of a global batch placed by ``layout``
    (``partition.Layout`` of the batch's specs): the longest major part
    of the axes that split the global batch whose size divides a
    microbatch's rows (``None`` where no part does).  A microbatch runs
    whole on every rank of the other axes."""
    mesh = layout.mesh
    b_ax = layout.specs["tokens"][0]
    rows = (batch["tokens"].shape[0]
            * partition.mesh_axis_size(mesh, b_ax) // n)
    names = partition.axis_names(b_ax)
    while names and rows % partition.mesh_axis_size(mesh, names):
        names = names[:-1]
    return None if not names else names[0] if len(names) == 1 else names


def _split_microbatches(batch: dict, n: int, layout=None) -> list:
    """The batch as ``n`` microbatches along its batch dim (the second dim
    of ``positions3`` (3, B, S)), in order, as the reference splits the
    global batch.  With a ``layout`` (``partition.Layout`` of the batch's
    specs) ``batch`` is this rank's part of the global batch, and
    microbatch i is this rank's part of the global batch's microbatch i
    along ``microbatch_axes`` (whole along the batch axes beyond them,
    where a microbatch's rows do not divide): each leaf is all-gathered
    along the axes that split it, split, and sliced back to this rank's
    part of each microbatch.  Nothing moves where those axes have size
    1."""
    def re(x):
        if x.dim() >= 2 and x.shape[0] == 3:   # positions3 (3, B, S)
            return x.reshape(3, n, x.shape[1] // n, *x.shape[2:]
                             ).transpose(0, 1)
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])

    if layout is None:
        split = tree_map(re, batch)
        return [tree_map(lambda x, i=i: x[i], split) for i in range(n)]
    mesh = layout.mesh
    b_ax, mb_ax = layout.specs["tokens"][0], microbatch_axes(batch, n, layout)

    def whole(x, spec):
        return partition.gather_along(x, spec, mesh,
                                      partition.sharded_axes(spec, mesh))

    def part(x, spec):
        return partition.local_slice(
            x, tuple(mb_ax if a == b_ax and a is not None else a
                     for a in spec), mesh)

    full = _split_microbatches(tree_map(whole, batch, layout.specs), n)
    return [tree_map(part, mb, layout.specs) for mb in full]


def _grads(cfg: ModelConfig, params: dict, batch: dict, layout=None,
           split=None):
    """(loss, metrics, grads) of ``factory.loss_fn`` at ``params``; the
    grads have the params' dtypes.  With a ``layout`` the params are
    this rank's shards and so are the grads, already averaged over the
    data-parallel axes.  ``split`` (``moe.Split``): the batch is this
    rank's part of the global batch."""
    live = dict(flatten(tree_map(lambda p: p.detach().requires_grad_(True),
                                 params)))
    with torch.enable_grad():
        loss, metrics = factory.loss_fn(
            cfg, map_with_path(lambda k, _: live[k], params), batch,
            layout, split)
        gs = torch.autograd.grad(loss, list(live.values()),
                                 allow_unused=True)
    by_path = {k: torch.zeros_like(p) if g is None else g
               for (k, p), g in zip(live.items(), gs)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics,
            map_with_path(lambda k, _: by_path[k], params))


def _loss_and_grads(cfg: ModelConfig, params: dict, batch: dict,
                    microbatches: int = 1, reduce=None, layout=None,
                    split=None, blayout=None):
    """(loss, metrics, grads) of the step before the update: the
    microbatches' float32 grads summed in order, then divided by the
    count (``metrics`` empty), or one batch's.  ``reduce(loss, metrics,
    grads)`` averages them over the data-parallel axes (the gathered
    path); a ``layout`` (``partition.Layout`` of the params' specs) runs
    on this rank's shards (the sharded path).  ``split``: the batch is
    this rank's part of the global batch (``moe.Split``); ``blayout``
    (the batch's ``partition.Layout``) makes each microbatch this rank's
    part of the global batch's (``_split_microbatches``), split only
    along ``microbatch_axes`` and so is ``split`` then: a microbatch run
    whole on several ranks is the same rows on each, and the means over
    the data-parallel axes average equal values."""
    if microbatches > 1:
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        loss = 0.0
        if blayout is not None and split is not None:
            split = moe.Split(split.mesh, microbatch_axes(
                batch, microbatches, blayout))
        for mb in _split_microbatches(batch, microbatches, blayout):
            mb_loss, _, g = _grads(cfg, params, mb, layout, split)
            grads = tree_map(lambda a, b: a + b.float(), grads, g)
            loss = loss + mb_loss
        grads = tree_map(lambda g: g / microbatches, grads)
        loss = loss / microbatches
        metrics = {}
    else:
        loss, metrics, grads = _grads(cfg, params, batch, layout, split)
    if reduce is not None:
        loss, metrics, grads = reduce(loss, metrics, grads)
    if layout is not None:       # the means over the data-parallel axes
        dp = partition.batch_axes(layout.mesh)
        n = partition.mesh_axis_size(layout.mesh, dp)
        loss = partition.all_reduce(loss, layout.mesh, dp) / n
        metrics = {k: partition.all_reduce(v, layout.mesh, dp) / n
                   for k, v in metrics.items()}
    return loss, metrics, grads


def _step(cfg: ModelConfig, ocfg: OptConfig, state: dict, batch: dict,
          microbatches: int, compress_grads: bool, reduce=None,
          layout=None, split=None, blayout=None):
    """The step on plain tensors: ``_loss_and_grads``, then the optional
    compression and AdamW (on this rank's shards with a ``layout``)."""
    params = state["params"]
    loss, metrics, grads = _loss_and_grads(cfg, params, batch, microbatches,
                                           reduce, layout, split, blayout)

    if compress_grads:
        grads, ef = compression.ef_compress_grads(grads, state["ef_error"],
                                                  layout)
        with torch.no_grad():
            tree_map(lambda e, new: e.copy_(new), state["ef_error"], ef)

    _, _, opt_metrics = apply_updates(ocfg, params, grads, state["opt"],
                                      layout)
    return state, {"loss": loss, **metrics, **opt_metrics}


def train_step_fn(cfg: ModelConfig, ocfg: OptConfig, state: dict,
                  batch: dict, microbatches: int = 1,
                  compress_grads: bool = False):
    """One step on plain tensors, in place: the state's params, optimizer
    state (and error-feedback residual) are updated.  Returns (state,
    metrics): ``loss`` (the microbatch mean), ``ce`` and ``aux`` at one
    microbatch, ``grad_norm`` and ``lr``.  Microbatch grads are summed in
    float32 in order, then divided by the count."""
    return _step(cfg, ocfg, state, batch, microbatches, compress_grads)


def param_state_pspecs(state_shapes: dict, mesh) -> dict:
    """Specs for the whole train state: the optimizer mirrors the
    params."""
    pp = partition.param_pspecs(state_shapes["params"], mesh)
    out = {"params": pp, "opt": {"mu": pp, "nu": pp, "step": ()}}
    if "master" in state_shapes["opt"]:
        out["opt"]["master"] = pp
    if "ef_error" in state_shapes:
        out["ef_error"] = pp
    return out


def _scatter_back(t, full: torch.Tensor) -> None:
    """Copy this rank's shards of the updated ``full`` into DTensor
    ``t`` (every rank holds the same ``full``: a local slice, no
    communication)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = t.device_mesh
    rep = DTensor.from_local(full, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    t.to_local().copy_(rep.redistribute(mesh, t.placements).to_local())


def _data_reduce(mesh):
    """(loss, metrics, grads) -> their means over the mesh's
    data-parallel axes (all-reduce sums, then one division); the
    identity where those axes have size 1."""
    import torch.distributed as dist

    axes = [a for a in partition.batch_axes(mesh)
            if partition.mesh_axis_size(mesh, a) > 1]
    if not axes:
        return None
    n = partition.mesh_axis_size(mesh, tuple(axes))

    def mean(t):
        t = t.clone()
        for a in axes:
            dist.all_reduce(t, group=mesh.get_group(a))
        return t / n

    def reduce(loss, metrics, grads):
        return mean(loss), tree_map(mean, metrics), tree_map(mean, grads)

    return reduce


def _local(tree):
    return tree_map(lambda t: t.to_local(), tree)


def make_train_step(cfg: ModelConfig, ocfg: OptConfig, mesh,
                    state_shapes: dict, batch_shapes: dict,
                    microbatches: int = 1, compress_grads: bool = False,
                    donate: bool = True):
    """The step on a ``DeviceMesh`` -> (step, pspecs, bspecs).

    ``state_shapes`` / ``batch_shapes`` are trees with the state's and the
    batch's leaf shapes (e.g. ``init_train_state(..., device="meta")``),
    from which the specs derive.  ``step(state, batch)`` takes the state
    and batch as DTensors placed by ``pspecs`` / ``bspecs``
    (``partition.logical_to_sharding``) and returns (state, metrics); the
    path (sharded or gathered) is the module docstring's.  With ``donate`` (the reference's donated buffers) the
    state's tensors are updated in place and returned; without, the
    caller's state is left as it was and the step returns a new one."""
    from torch.distributed.tensor import DTensor

    pspecs = param_state_pspecs(state_shapes, mesh)
    bspecs = partition.batch_pspecs(batch_shapes, mesh)
    reduce = _data_reduce(mesh)
    sharded = factory.shards(cfg, mesh)
    split = moe.Split(mesh, bspecs["tokens"][0])

    @torch.no_grad()
    def step(state: dict, batch: dict):
        if not donate:
            state = tree_map(lambda t: DTensor.from_local(
                t.to_local().clone(), t.device_mesh, t.placements,
                run_check=False), state)
        blayout = partition.Layout.of(batch) if microbatches > 1 else None
        if sharded:
            _, metrics = _step(cfg, ocfg, _local(state), _local(batch),
                               microbatches, compress_grads,
                               layout=partition.Layout.of(state["params"]),
                               split=split, blayout=blayout)
            return state, metrics
        full = tree_map(partition.full_value, state)
        _, metrics = _step(cfg, ocfg, full, _local(batch), microbatches,
                           compress_grads, reduce, split=split,
                           blayout=blayout)
        tree_map(lambda t, f: None if partition._is_whole(t)
                 else _scatter_back(t, f), state, full)
        return state, metrics

    return step, pspecs, bspecs
