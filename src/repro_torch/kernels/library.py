"""The hand-written kernels as ``torch.library`` ops in the ``repro_torch``
namespace (``torch.ops.repro_torch.<kernel>``), one op per launch
wrapper of ``espim_spmv.py``, ``dense_mv.py``, ``flash_attention.py``,
``wkv.py`` and ``decode_attention.py``.

Each op has two implementations:

* ``CUDA``: the launch itself (ctypes on ``data_ptr()``, on the current
  stream), which adds one to the kernel's ``LAUNCHES`` count;
* ``Meta``: the output's shape and dtype only.  ``FakeTensorMode`` runs it
  on fake tensors of any device (a dry run's fake ``cuda`` tensors), so a
  traced step sees one node with the kernel's name, touches no pointer
  and counts no launch.

The wrappers check their operands in Python and then call the kernel
``define`` returns, so a real launch and a fake call take the same
checks.  On plain tensors with no dispatch mode active (serving,
training) it calls the launch directly, as the wrappers did before the
ops existed: through the dispatcher the sparse engine's TPOT read 1.041x
the parent's and 1.07x this direct call's (``scripts/engine_ab.py``, 30
rounds each; PERF.md), the direct call 0.976x the parent's.  Under any
dispatch mode (``FakeTensorMode``, the cost analysis) or on a tensor
subclass it calls the op.  The ops are defined through
``torch.library.Library`` with plain ``define`` / ``impl`` calls, not
the ``custom_op`` decorator, whose wrapper objects add Python work to
every call.

``COSTS[name](args, out) -> (flops, bytes)`` is the op's count for
``launch/cost_analysis.py``: every tensor input read once and every
output written once, and the kernel's operations as ``chip_smoke.py``'s
bound column counts them (2 x ELL slots x B for the SpMV family, 2 R C
for dense MV, 4 BH hd x the (query, key) pairs for attention, every
cache row a pair for decode attention; the WKV ops the products
``CostMode`` counts in the plain loop they replace).
The same count is registered with ``torch.utils.flop_counter``, so a
``FlopCounterMode`` on the card sees each op's products.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

__all__ = ["LIB", "COSTS", "define", "tensor_bytes"]

LIB = torch.library.Library("repro_torch", "DEF")
COSTS: dict = {}


def tensor_bytes(t) -> int:
    """Bytes of a tensor, or of every tensor of a tuple or list."""
    if isinstance(t, (tuple, list)):
        return sum(tensor_bytes(x) for x in t)
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def define(schema: str, launch, meta, flops):
    """Define ``repro_torch::<name>`` from ``schema`` with ``launch`` as
    its CUDA kernel and ``meta`` as its Meta kernel; ``flops(*args)``
    counts its operations.  Returns the kernel: ``launch`` itself on a
    plain tensor outside any dispatch mode, else the op (its arguments
    positional, the first a tensor)."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, launch, "CUDA")
    LIB.impl(name, meta, "Meta")

    def cost(args, out):
        read = sum(tensor_bytes(a) for a in args)
        return float(flops(*args)), float(read + tensor_bytes(out))

    COSTS[name] = cost
    op = getattr(torch.ops.repro_torch, name)
    register_flop_formula(op, get_raw=True)(
        lambda *args, out_val=None, **kwargs: flops(*args))

    def kernel(*args):
        if (type(args[0]) is torch.Tensor
                and torch._C._len_torch_dispatch_stack() == 0):
            return launch(*args)
        return op(*args)

    return kernel
