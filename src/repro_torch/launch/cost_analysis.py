"""Cost analysis of one eager step: dot FLOPs, elementwise FLOPs, bytes
and collective traffic per device, counted from the aten ops the step
dispatches.  This replaces ``src/repro/launch/hlo_analysis.py``, which
parses XLA's optimized HLO: an eager PyTorch step has no HLO, so
``analyze_step`` runs the step under a ``TorchDispatchMode`` and counts
every op it sees (forward, autograd's backward and the recompute of a
checkpointed layer alike), on real or fake tensors.

  * dot FLOPs = 2 * numel(result) * the contracting dim, for ``mm``,
    ``addmm``, ``bmm`` and ``baddbmm``; the hand-written kernels' ops
    (``torch.ops.repro_torch.*``) count their own formula
    (``kernels/library.COSTS``: 2 x ELL slots x B for the SpMV family);
  * elementwise FLOPs = numel(result) of every other op that computes
    (the reference's minor term); views and allocations count nothing;
  * bytes: every op reads its tensor inputs once and writes its outputs
    once (the bound column's rule, ``chip_smoke.py``); ``dot_bytes`` are
    the products' operand and result bytes;
  * collective bytes: the operand bytes per device of every c10d op,
    functional (DTensor's redistribution) or not (``dist.all_reduce``),
    under the reference's five kinds.  A broadcast or a point-to-point
    send counts as ``collective-permute``.
An eager loop dispatches its body once per iteration, so a loop's trip
count scales its cost with no bookkeeping.  ``StepCost.as_dict()`` has
``HLOCost.as_dict()``'s keys exactly.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels.library import COSTS, tensor_bytes

__all__ = ["StepCost", "CostMode", "analyze_step"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
# product -> index of the left operand, whose last dim is contracted
_DOTS = {_aten.mm.default: 0, _aten.addmm.default: 1,
         _aten.bmm.default: 0, _aten.baddbmm.default: 1}
# ops that allocate or describe without computing
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "alias", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "device",
         "wait_tensor", "barrier", "monitored_barrier_"}
# c10d op -> (kind, index of the argument holding its operands); the
# functional ops take their input first, the in-place ops their output
# list first where they have one
_C10D = {
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "all_reduce": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0),
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "all_to_all_single": ("all-to-all", 0),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "broadcast": ("collective-permute", 0),
    "broadcast_": ("collective-permute", 0),
    "send": ("collective-permute", 0),
    "recv_": ("collective-permute", 0),
}


@dataclasses.dataclass
class StepCost:
    flops: float = 0.0
    dot_flops: float = 0.0
    dot_bytes: float = 0.0
    bytes: float = 0.0
    collective_bytes: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))
    collective_counts: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "dot_flops": self.dot_flops,
            "dot_bytes": self.dot_bytes,
            "bytes": self.bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_counts": dict(self.collective_counts),
            "collective_total_bytes": self.total_collective_bytes,
        }


def _bytes(tree) -> int:
    return sum(tensor_bytes(t) for t in tree_leaves(tree))


def _numel(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class CostMode(TorchDispatchMode):
    """Counts the ops dispatched inside it into ``self.cost``."""

    def __init__(self):
        super().__init__()
        self.cost = StepCost()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        c = self.cost
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns == "repro_torch":
            flops, nbytes = COSTS[name](args, out)
            c.flops += flops
            c.dot_flops += flops
            c.dot_bytes += nbytes
            c.bytes += nbytes
            return
        if name in _C10D and ns in ("c10d", "_c10d_functional",
                                    "c10d_functional"):
            kind, i = _C10D[name]
            c.collective_bytes[kind] += _bytes(args[i])
            c.collective_counts[kind] += 1
            return
        if func.is_view or name in _FREE or ns in ("c10d", "prim",
                                                  "_c10d_functional"):
            return
        nbytes = _bytes((args, kwargs)) + _bytes(out)
        c.bytes += nbytes
        if func in _DOTS:
            lhs = args[_DOTS[func]]
            fl = 2.0 * out.numel() * lhs.shape[-1]
            c.flops += fl
            c.dot_flops += fl
            c.dot_bytes += (tensor_bytes(lhs) + tensor_bytes(
                args[_DOTS[func] + 1]) + tensor_bytes(out))
        else:
            c.flops += _numel(out)


def analyze_step(fn, *args, **kwargs) -> StepCost:
    """``fn(*args, **kwargs)`` once under ``CostMode``; its cost."""
    with CostMode() as mode:
        fn(*args, **kwargs)
    return mode.cost
