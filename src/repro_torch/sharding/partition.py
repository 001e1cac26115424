"""Partitioning rules: param / batch / cache trees -> spec trees, and the
specs as DTensor placements (mirrors ``src/repro/sharding/partition.py``).

Strategy, as the reference's:
  * TP on ``model`` for head / ffn / vocab dims (column-parallel up / QKV,
    row-parallel down / out projections, EP for MoE experts);
  * FSDP on ``data`` for the non-TP weight dim;
  * batch dims on ``('pod', 'data')`` when the pod axis exists;
  * an axis is used only where the dim divides by its extent (else the
    dim is replicated).

The rules are pure functions of the tree's paths and leaf shapes and of a
mesh *shape*: a torch ``DeviceMesh`` (its ``mesh_dim_names`` and
``shape``) or a ``MeshShape`` (axis names -> sizes), so specs for a 4x4 or
2x2x4 mesh need no processes.  A spec is a tuple with one entry per dim:
``None``, an axis name, or a tuple of names (``("pod", "data")``) — the
reference's ``PartitionSpec`` as a tuple, a one-name tuple written as the
name.  ``named`` turns specs into DTensor placements on a real mesh.
Optimizer state inherits the param spec leaf for leaf.

The collectives of a placement run a sharded step on each rank's local
tensors: ``gather_along`` (all-gather a shard along named mesh axes),
``reduce_scatter_to`` (the mean over named axes, left as this rank's
shard), ``local_slice`` (this rank's shard of a value every rank holds),
``sum_to_shard`` (the sum of partial products over named axes, left as
this rank's rows of an activation gathered along the batch axes), and
the autograd pairs the sharded steps are written with
(``fsdp_gather``, ``copy_to``, ``reduce_from``, ``gather_dim``,
``gather_whole``, and ``psum`` for statistics summed over ranks: the MoE
family's over a dispatch group that spans the data-parallel ranks,
zamba2's gated norm over its heads on ``model``).  They run on the
mesh's axis subgroups (``mesh.get_group(axis)``) through
``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
``all_reduce``, which gloo, NCCL and the fake process group all take; an
axis of size 1 is no collective at all (the same tensor, not a copy).
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
import torch.distributed as dist

from repro_torch.tree import flatten, map_with_path, tree_map

__all__ = [
    "MeshShape", "batch_axes", "mesh_axis_size", "param_pspecs",
    "serve_param_pspecs", "batch_pspecs", "cache_pspecs",
    "paged_cache_pspecs", "sparse_pack_pspecs", "named",
    "logical_to_sharding", "full_value", "Layout", "spec_of",
    "axis_names", "axis_index", "sharded_axes", "gather_along",
    "reduce_scatter_to", "local_slice", "all_reduce", "sum_to_shard",
    "fsdp_gather", "copy_to", "reduce_from", "gather_dim", "gather_whole",
    "psum",
]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices: ``MeshShape.of(
    data=4, model=4)``."""

    axes: tuple             # ((name, size), ...) in mesh order

    @classmethod
    def of(cls, **sizes) -> "MeshShape":
        return cls(tuple(sizes.items()))

    @property
    def axis_names(self) -> tuple:
        return tuple(n for n, _ in self.axes)

    @property
    def shape(self) -> dict:
        return dict(self.axes)


# a DeviceMesh's {axis: size} and this rank's {axis: coordinate}, read
# once: a sharded step asks for them per layer and leaf, and a
# DeviceMesh computes them anew on every call
_SIZES = weakref.WeakKeyDictionary()
_COORDS = weakref.WeakKeyDictionary()


def _axes(mesh) -> dict:
    """{axis name: size} of a ``MeshShape`` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    sizes = _SIZES.get(mesh)
    if sizes is None:
        sizes = _SIZES[mesh] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return sizes


def mesh_axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = _axes(mesh)
    if isinstance(axis, (tuple, list)):
        out = 1
        for a in axis:
            out *= sizes[a]
        return out
    return sizes[axis]


def batch_axes(mesh) -> tuple:
    """The composed data-parallel axis: ('pod', 'data') on multi-pod."""
    return ("pod", "data") if "pod" in _axes(mesh) else ("data",)


def _norm_axis(axis):
    """A one-name tuple as the name, as ``PartitionSpec`` writes it."""
    if isinstance(axis, (tuple, list)):
        axis = tuple(axis)
        return axis[0] if len(axis) == 1 else axis
    return axis


def _fit(mesh, dim: int, axis):
    """axis if dim divides by its extent, else None (replicate)."""
    if axis is None:
        return None
    return _norm_axis(axis) if dim % mesh_axis_size(mesh, axis) == 0 else None


def _spec(mesh, shape, axes) -> tuple:
    """A spec, dropping axes that do not divide."""
    return tuple(_fit(mesh, d, a) for d, a in zip(shape, axes))


def _replicated(nd: int) -> tuple:
    return (None,) * nd


# Rules match on exact leaf names / path suffixes (not substrings: "u" is
# an RWKV leaf and must not swallow "w_up").  Leading layer-stack dims are
# never sharded.
_ROW_PARALLEL = ("w_down", "out_proj", "attn/wo", "self_attn/wo",
                 "cross_attn/wo", "tm/wo", "cm/wv")
_REPLICATED_LEAVES = {"w", "b", "a_log", "d_skip", "dt_bias", "mix", "w0",
                      "u", "conv_b", "norm_w", "ln_x", "router"}


def _param_rule(path: str, shape, mesh, fsdp: bool, tp) -> tuple:
    dp = "data" if fsdp else None
    nd = len(shape)
    leaf = path.rsplit("/", 1)[-1]
    stacked = "layers/" in path     # leading dim is the layer stack

    def tail(*axes):
        return _spec(mesh, shape, (None,) * (nd - len(axes)) + tuple(axes))

    if leaf in _REPLICATED_LEAVES:
        return _replicated(nd)
    # head-structured weights never take the wide TP axis (a head_dim
    # split across devices turns every QK / PV contraction into a
    # partial-sum all-reduce)
    headed = any(k in path for k in ("attn/", "tm/", "mamba/", "conv_w"))
    wtp = "model" if headed else tp
    # an axis may appear once per spec: FSDP yields to a wide TP that
    # already uses 'data'
    wide_uses_data = isinstance(wtp, (tuple, list)) and "data" in wtp
    dpw = None if wide_uses_data else dp
    tp_uses_data = isinstance(tp, (tuple, list)) and "data" in tp
    dpt = None if tp_uses_data else dp
    # MoE experts: EP on 'model'; the FFN dim takes 'data' (FSDP on d_model
    # when training, TP on d_ff when serving)
    if "moe/w_gate" in path or "moe/w_up" in path:    # (L, E, D, F)
        return tail("model", dp, None if fsdp else "data")
    if "moe/w_down" in path:                          # (L, E, F, D)
        return tail("model", None if fsdp else "data", dp)
    if path.endswith("pos_embed") or path.endswith("embed"):  # (V|S, D)
        return tail(tp, None)
    if path.endswith("lm_head"):                      # (D, V)
        return tail(dpt, tp)
    if "conv_w" in path:                              # (L, K, C)
        return tail(None, wtp)
    if any(path.endswith(k) or f"{k}/" in path for k in _ROW_PARALLEL):
        return tail(wtp, dpw)                         # (L, F_in, D)
    if nd >= 3 or (nd == 2 and not stacked):          # column-parallel
        return tail(dpw, wtp)
    if nd == 2:                                       # stacked bias (L, F)
        return tail(wtp)
    return _replicated(nd)                            # scalars / 1-D


def param_pspecs(params_or_shapes, mesh, fsdp: bool = True, tp="model"):
    """A spec tree matching a params tree (any leaves with ``.shape``:
    tensors, meta tensors, shape stand-ins).  ``tp`` is the
    tensor-parallel axis or axis tuple; serving uses ('data', 'model')."""
    return map_with_path(
        lambda path, leaf: _param_rule(path, tuple(leaf.shape), mesh, fsdp,
                                       tp), params_or_shapes)


def serve_param_pspecs(params_or_shapes, mesh,
                       global_batch: int | None = None):
    """Decode-time layout: no FSDP, TP over (data x model); at
    global_batch == 1 the contraction dim also shards over 'data'."""
    tp = tuple(a for a in ("data", "model") if a in _axes(mesh))
    return param_pspecs(params_or_shapes, mesh, fsdp=global_batch == 1,
                        tp=tp)


def batch_pspecs(batch_tree, mesh):
    """Every leading batch dim over ('pod', 'data') when divisible;
    ``positions3`` (3, B, S) on its second dim."""
    ba = batch_axes(mesh)

    def leaf_spec(leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd == 0:
            return ()
        if shape[0] == 3 and nd == 3:
            return _spec(mesh, shape, (None, ba, None))
        return _spec(mesh, shape, (ba,) + (None,) * (nd - 1))

    return tree_map(leaf_spec, batch_tree)


def cache_pspecs(cache_tree, mesh):
    """Decode caches (L, B, S, KV, hd) and friends: B over the batch axes
    when divisible; heads over 'model' when divisible, else the sequence
    / state dim picks 'model' up (and any idle batch axis)."""
    ba = batch_axes(mesh)
    names = _axes(mesh)

    def leaf_spec(name, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd <= 1:
            return _replicated(nd)
        if name.endswith("len"):
            return (None,)
        if nd == 5 or name.endswith("_scale"):
            # (L, B, S, KV, hd) kv cache / (L, B, H, K, V) wkv state /
            # (L, B, S, KV) int8-cache scales
            b, s, kv = shape[1:4]
            b_ax = _fit(mesh, b, ba)
            kv_ax = _fit(mesh, kv, "model")
            leftover = [a for a in ("pod", "data")
                        if a in names and b_ax is None]
            if kv_ax is None and "model" in names:
                leftover.append("model")
            s_ax = _fit(mesh, s, tuple(leftover)) if leftover else None
            return (None, b_ax, s_ax, kv_ax) + ((None,) if nd == 5 else ())
        if nd == 4:     # (L, B, K-1, C) conv state
            return (None, _fit(mesh, shape[1], ba), None,
                    _fit(mesh, shape[3], "model"))
        return _spec(mesh, shape, (None, ba) + (None,) * (nd - 2))

    return map_with_path(leaf_spec, cache_tree)


def paged_cache_pspecs(pages_tree, mesh):
    """Block-pool KV arenas (Lx, num_blocks, block_size, KV[, hd]): the
    blocks over the batch axes, KV heads over 'model', a block never
    split."""
    ba = batch_axes(mesh)

    def leaf_spec(leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd < 4:
            return _replicated(nd)
        return (None, _fit(mesh, shape[1], ba), None,
                _fit(mesh, shape[3], "model")) + (None,) * (nd - 4)

    return tree_map(leaf_spec, pages_tree)


def sparse_pack_pspecs(sparse: dict, mesh):
    """Specs for the device planes of a ``sparsify_model`` dict: each
    bucket's packed-row dim (values / q, cols, srow) over 'model' when
    divisible — devices as the paper's banks — layer and chunk dims never
    split, ``perm`` / ``inv_perm`` replicated.  Returns ``{group:
    {"buckets": [...], "perm", "inv_perm"}}``."""
    def bucket_spec(b):
        out = {}
        for key in ("values", "q", "cols", "srow"):
            if key in b:
                shape = tuple(b[key].shape)
                out[key] = ((None, _fit(mesh, shape[1], "model"))
                            + (None,) * (len(shape) - 2))
        return out

    return {name: {"buckets": [bucket_spec(b) for b in g["buckets"]],
                   "perm": (None, None), "inv_perm": (None, None)}
            for name, g in sparse["groups"].items()}


def named(mesh, spec):
    """A spec as DTensor placements on ``mesh`` (a ``DeviceMesh``), one per
    mesh dim: ``Shard(d)`` on each mesh dim whose axis the spec puts on
    tensor dim d, ``Replicate()`` elsewhere.  A dim split over several
    axes (``("pod", "data")``) is split major axis first, as the
    reference's: DTensor splits over the mesh dims in mesh order, so the
    names must come in that order (raises otherwise).  A tree of specs
    maps leaf for leaf."""
    from torch.distributed.tensor import Replicate, Shard

    if isinstance(spec, dict):
        return {k: named(mesh, v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [named(mesh, v) for v in spec]
    order = list(mesh.mesh_dim_names)
    placements = [Replicate()] * len(order)
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        group = (axis,) if isinstance(axis, str) else tuple(axis)
        idx = [order.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"axes {group} on dim {d} are not in mesh order "
                             f"{tuple(order)}")
        for i in idx:
            placements[i] = Shard(d)
    return placements


def _place(x: torch.Tensor, spec: tuple, mesh):
    """One leaf on ``mesh`` per ``spec``, from the full value that every
    rank holds alike.  Where every sharded mesh dim has size 1 the local
    shard is the whole tensor, which becomes the DTensor's local tensor
    as it is (no copy: a full-width train state fits the card once, not
    twice); else ``distribute_tensor`` keeps this rank's shard of its own
    ``x`` (``src_data_rank=None``: no scatter or broadcast from a source
    rank)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    placements = named(mesh, spec)
    x = x.to(mesh.device_type)
    if all(mesh.size(i) == 1 for i, p in enumerate(placements)
           if p.is_shard()):
        return DTensor.from_local(x, mesh, placements, run_check=False)
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def logical_to_sharding(tree, specs, mesh):
    """A tree of tensors placed on ``mesh`` (a ``DeviceMesh``) per a spec
    tree: a tree of DTensors."""
    return tree_map(lambda x, s: _place(x, s, mesh), tree, specs)


def _is_whole(t) -> bool:
    return tuple(t.to_local().shape) == tuple(t.shape)


def full_value(t) -> torch.Tensor:
    """A DTensor's full value as a plain tensor: its local tensor itself
    where that is whole (every sharded mesh dim of size 1: no copy, so an
    in-place update writes the DTensor), else an all-gather; a plain
    tensor as it is."""
    if not hasattr(t, "to_local"):
        return t
    return t.to_local() if _is_whole(t) else t.full_tensor()


# --------------------------------------------------------------------------
# the collectives of a placement
# --------------------------------------------------------------------------
def axis_names(axis) -> tuple:
    """A spec entry as a tuple of axis names: () for None."""
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def spec_of(t) -> tuple:
    """A DTensor's placements as a spec (the inverse of ``named``): each
    tensor dim names the mesh axes that split it, in mesh order."""
    names = t.device_mesh.mesh_dim_names
    per_dim = [[] for _ in range(t.dim())]
    for i, p in enumerate(t.placements):
        if p.is_shard():
            per_dim[p.dim].append(names[i])
    return tuple(_norm_axis(a) if a else None for a in per_dim)


@dataclasses.dataclass(frozen=True)
class Layout:
    """A sharded tree's specs on a ``DeviceMesh``: what a step on the
    local tensors needs to know of the placement."""

    mesh: object
    specs: dict             # a spec tree matching the local tensors

    @classmethod
    def of(cls, tree) -> "Layout":
        """The layout of a tree of DTensors, read from their placements."""
        some = next(t for _, t in flatten(tree))
        return cls(some.device_mesh, tree_map(spec_of, tree))


def axis_index(mesh, axis) -> int:
    """This rank's coordinate along ``axis`` (a name, or a tuple of names
    split major first, as ``named`` places them)."""
    coords = _COORDS.get(mesh)
    if coords is None:
        coords = _COORDS[mesh] = {a: mesh.get_local_rank(a)
                                  for a in mesh.mesh_dim_names}
    idx = 0
    for a in axis_names(axis):
        idx = idx * mesh_axis_size(mesh, a) + coords[a]
    return idx


def sharded_axes(spec, mesh) -> tuple:
    """The mesh axes of size > 1 that split a leaf of ``spec``: those over
    which its shards differ."""
    return tuple(a for axis in spec for a in axis_names(axis)
                 if mesh_axis_size(mesh, a) > 1)


# ``all_gather_into_tensor`` / ``reduce_scatter_tensor`` under the names
# that newer PyTorch gives them (the old names warn there)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor", None)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or getattr(
    dist, "reduce_scatter_tensor", None)


def _all_gather_dim(t, dim: int, mesh, axis: str):
    n = mesh_axis_size(mesh, axis)
    if n == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _ALL_GATHER(out, x, group=mesh.get_group(axis))
    return out.movedim(0, dim)


def _reduce_scatter_dim(t, dim: int, mesh, axis: str):
    """The sum over ``axis`` of ``t``, split along ``dim``: this rank's
    piece."""
    n = mesh_axis_size(mesh, axis)
    if n == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    _REDUCE_SCATTER(out, x, group=mesh.get_group(axis))
    return out.movedim(0, dim)


def all_reduce(t, mesh, axes, op: str = "sum"):
    """``t`` reduced ("sum" or "max") over the mesh axes ``axes`` (a name
    or names): a new tensor; ``t`` itself where they all have size 1."""
    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    out = t
    for a in axis_names(axes):
        if mesh_axis_size(mesh, a) > 1:
            if out is t:
                out = t.clone()
            dist.all_reduce(out, op=red, group=mesh.get_group(a))
    return out


def _taken(spec, axes) -> list:
    """Per dim of ``spec``, the names among ``axes`` that split it, major
    first; they must be the dim's minor names (a gather along a major
    axis alone would interleave the pieces)."""
    out = []
    for d, axis in enumerate(spec):
        names = axis_names(axis)
        take = tuple(a for a in names if a in axes)
        if take and names[len(names) - len(take):] != take:
            raise ValueError(f"dim {d} is split over {names}: cannot gather "
                             f"along {take} alone")
        out.append(take)
    return out


def gather_along(t, spec, mesh, axes):
    """This rank's shard ``t`` of a leaf placed by ``spec``, all-gathered
    along the mesh axes ``axes`` only (the leaf stays split over its
    other axes): FSDP gathers along ``("data",)``, serving along every
    axis."""
    for d, take in enumerate(_taken(spec, axes)):
        for a in reversed(take):            # minor first
            t = _all_gather_dim(t, d, mesh, a)
    return t


def _reduce_scatter_sum(g, spec, mesh, axes):
    """The sum over ``axes`` of ``g`` (full along the axes of ``axes``
    that split it), left as this rank's shard along them; an axis of
    ``axes`` that does not split the leaf is all-reduced."""
    used = set()
    for d, take in enumerate(_taken(spec, axes)):
        for a in take:                      # major first
            g = _reduce_scatter_dim(g, d, mesh, a)
        used.update(take)
    return all_reduce(g, mesh, tuple(a for a in axes if a not in used))


def reduce_scatter_to(g, spec, mesh, axes):
    """The mean over the mesh axes ``axes`` (the data-parallel ones) of
    each rank's ``g``, left as this rank's shard of ``spec``: a
    reduce-scatter along the axes that split the leaf, an all-reduce
    along the others, then one division."""
    n = mesh_axis_size(mesh, tuple(axes))
    g = _reduce_scatter_sum(g, spec, mesh, axes)
    return g / n if n > 1 else g


def _slice_dim(t, dim: int, mesh, axis: str):
    """This rank's piece of ``t`` along ``dim`` split over ``axis``."""
    n = mesh_axis_size(mesh, axis)
    if n == 1:
        return t
    c = t.shape[dim] // n
    return t.narrow(dim, axis_index(mesh, axis) * c, c)


def sum_to_shard(t, mesh, axes, dim: int, along=None):
    """The sum over the mesh axes ``axes`` of each rank's partial ``t``,
    left as this rank's piece of ``dim`` along ``along`` (a spec entry:
    the axes, major first, along which ``t`` holds the rows that an
    all-gather of an activation brought in).  Per axis of ``along``,
    major first: a reduce-scatter where the sum runs over it, a slice
    where not; then an all-reduce over the rest of ``axes``.  ``t``
    itself where they all have size 1."""
    names, rows = axis_names(axes), axis_names(along)
    for a in rows:
        t = (_reduce_scatter_dim(t, dim, mesh, a) if a in names
             else _slice_dim(t, dim, mesh, a))
    return all_reduce(t, mesh, tuple(a for a in names if a not in rows))


def local_slice(full, spec, mesh):
    """This rank's shard of ``spec`` of a value that every rank holds
    alike: a view, no communication."""
    for d, axis in enumerate(spec):
        n = mesh_axis_size(mesh, axis)
        if n > 1:
            c = full.shape[d] // n
            full = full.narrow(d, axis_index(mesh, axis) * c, c)
    return full


class _Dual(torch.autograd.Function):
    """``fwd(x)`` in the forward, ``bwd(grad)`` in the backward."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        out = fwd(x)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, grad):
        return ctx.bwd(grad), None, None


def _dual(x, fwd, bwd):
    if torch.is_grad_enabled() and x.requires_grad:
        return _Dual.apply(x, fwd, bwd)
    return fwd(x)


def fsdp_gather(t, spec, mesh):
    """ZeRO-3's gather of a param: ``t`` (this rank's shard) all-gathered
    along the data axis; in the backward its gradient becomes the mean
    over the data-parallel axes (``batch_axes``), reduce-scattered to this
    rank's shard where ``data`` splits the leaf and all-reduced where
    not.  ``t`` itself where those axes all have size 1."""
    dp = batch_axes(mesh)
    if mesh_axis_size(mesh, dp) == 1:
        return t
    return _dual(t, lambda x: gather_along(x, spec, mesh, ("data",)),
                 lambda g: reduce_scatter_to(g, spec, mesh, dp))


def copy_to(x, mesh, axis: str = "model"):
    """Enter a tensor-parallel region: the identity, whose backward sums
    the ranks' partial gradients over ``axis`` (Megatron's f)."""
    if mesh_axis_size(mesh, axis) == 1:
        return x
    return _dual(x, lambda y: y, lambda g: all_reduce(g, mesh, axis))


def reduce_from(x, mesh, axis: str = "model"):
    """Leave a tensor-parallel region: the sum of the ranks' partial
    results over ``axis``, whose backward is the identity (Megatron's
    g)."""
    if mesh_axis_size(mesh, axis) == 1:
        return x
    return _dual(x, lambda y: all_reduce(y, mesh, axis), lambda g: g)


def gather_dim(x, dim: int, mesh, axis):
    """A rank-local activation all-gathered along ``dim`` over ``axis`` (a
    name or names, major first) for rank-local use: its backward sums
    the ranks' partial gradients and keeps this rank's piece (a
    reduce-scatter)."""
    spec = tuple(axis if d == dim else None for d in range(x.dim()))
    names = axis_names(axis)
    if mesh_axis_size(mesh, names) == 1:
        return x
    return _dual(x, lambda y: gather_along(y, spec, mesh, names),
                 lambda g: _reduce_scatter_sum(g, spec, mesh, names))


def gather_whole(x, dim: int, mesh, axis: str = "model"):
    """A rank-local piece all-gathered along ``dim`` over ``axis`` into a
    value that every rank then uses alike (as the residual stream is
    used, whose gradient is the same on every rank): its backward keeps
    this rank's piece of the gradient, with no sum (``gather_dim``'s
    backward sums partial gradients instead)."""
    spec = tuple(axis if d == dim else None for d in range(x.dim()))
    if mesh_axis_size(mesh, axis) == 1:
        return x
    return _dual(x, lambda y: gather_along(y, spec, mesh, (axis,)),
                 lambda g: local_slice(g, spec, mesh))


def psum(x, mesh, axes):
    """The sum over the mesh axes ``axes`` of each rank's ``x``, for a
    value that every rank then uses alike in its own loss: its backward
    sums the ranks' gradients too (the all-reduce's adjoint).  With the
    step's mean over the data-parallel axes, each rank's share of the
    sum then gets the gradient of the one shared value.  ``x`` itself
    where the axes all have size 1."""
    names = tuple(a for a in axis_names(axes) if mesh_axis_size(mesh, a) > 1)
    if not names:
        return x
    return _dual(x, lambda y: all_reduce(y, mesh, names),
                 lambda g: all_reduce(g, mesh, names))
