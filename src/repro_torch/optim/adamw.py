"""AdamW with warmup + cosine schedule, global-norm clipping, and an
optional float32 master copy of low-precision params (mirrors
``src/repro/optim/adamw.py``).

Trees are nested dicts of tensors.  The reference returns new trees and
donates the old buffers to XLA; here the update is in place under
``torch.no_grad()``: each leaf's new value is computed out of place, in
the reference's order of float32 operations, then ``copy_`` into the
param and state tensors, which ``apply_updates`` returns.  The schedule
and the bias corrections are 0-dim float32 tensors on the state's
device, so a step never waits for the host.

On a mesh (``layout``: a ``partition.Layout`` of the params' specs) the
trees are each rank's local shards: the update is elementwise, so it runs
on them as they are, and only the global norm communicates.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.sharding import partition
from repro_torch.tree import flatten, leaves, tree_map

__all__ = ["OptConfig", "init_opt_state", "apply_updates", "lr_at"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    master_fp32: bool = True


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor) as a float32
    tensor: linear warmup to ``peak_lr``, then a cosine down to
    ``min_lr_frac`` of it at ``decay_steps``."""
    step = torch.as_tensor(step).float()
    warm = cfg.peak_lr * step / max(1.0, cfg.warmup_steps)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1.0, cfg.decay_steps - cfg.warmup_steps), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_opt_state(cfg: OptConfig, params: dict) -> dict:
    """Zero float32 ``mu`` and ``nu`` per param, ``step`` 0 (int32), and a
    float32 ``master`` copy of every param when ``master_fp32`` is set
    and some param is not float32."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = leaves(params)[0].device
    state = {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.master_fp32 and any(p.dtype != torch.float32
                               for p in leaves(params)):
        # a copy also of the float32 leaves: the update writes the master
        # and the param separately
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def _global_norm(tree, layout=None) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted key order) of sum(g^2) in
    float32.  With a ``layout`` the leaves are local shards: the squares
    are summed per set of mesh axes that split a leaf, each sum
    all-reduced over its axes only, so a leaf replicated over an axis is
    counted once (on one rank the sum is the plain one, bit for bit)."""
    if layout is None:
        sq = [torch.sum(torch.square(g.float())) for g in leaves(tree)]
        return torch.sqrt(sum(sq))
    specs = dict(flatten(layout.specs))
    by_axes = {}
    for path, g in flatten(tree):
        axes = partition.sharded_axes(specs[path], layout.mesh)
        by_axes[axes] = by_axes.get(axes, 0) + torch.sum(
            torch.square(g.float()))
    return torch.sqrt(sum(partition.all_reduce(v, layout.mesh, axes)
                          for axes, v in by_axes.items()))


@torch.no_grad()
def apply_updates(cfg: OptConfig, params: dict, grads: dict, state: dict,
                  layout=None):
    """One AdamW step, in place.  Returns (params, state, metrics) — the
    caller's trees, updated — with metrics ``grad_norm`` (before
    clipping) and ``lr``.  With a ``layout`` every tree holds this rank's
    shards (``_global_norm``)."""
    step = state["step"] + 1
    gnorm = _global_norm(grads, layout)
    scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                        max=1.0)
    lr = lr_at(cfg, step)
    stepf = step.float()
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)

    master = state.get("master")
    base = master if master is not None else params
    flat_g = dict(flatten(grads))
    flat_mu = dict(flatten(state["mu"]))
    flat_nu = dict(flatten(state["nu"]))
    flat_p = dict(flatten(params))
    for path, b in flatten(base):
        # the moments are written as soon as they are computed, so that
        # few temporaries of the largest leaf are alive at once
        g = flat_g[path].float() * scale
        mu, nu = flat_mu[path], flat_nu[path]
        mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * torch.square(g))
        del g
        step_dir = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        pf = b.float()
        pf = pf - lr * (step_dir + cfg.weight_decay * pf)
        del step_dir
        if master is not None:
            b.copy_(pf)
        flat_p[path].copy_(pf.to(flat_p[path].dtype))
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
