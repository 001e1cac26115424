"""Family dispatch (mirrors ``src/repro/models/factory.py``): one model API
over the six families.

  init_params(cfg, generator, device) -> params dict (stacked layers)
  apply_train(cfg, params, batch)     -> (logits, aux_loss)
  init_cache(cfg, B, max_len, device) -> decode cache dict
  decode_step(cfg, params, cache, batch) -> (logits, cache)
  prefill_chunk(cfg, params, cache, batch) -> (logits, cache)
  loss_fn(cfg, params, batch)         -> (loss, metrics)

Every family also runs on each rank's shards of a mesh whose ``model``
axis divides its tensor-parallel widths (``shards``):
``apply_train_sharded``, ``loss_fn(..., layout=)`` and
``decode_step_sharded`` (tensor-parallel products, no param leaf
gathered).  On a mesh where it does not divide them, the sharded steps
gather the params first.  ``split`` (``moe.Split``) says where a rank's
batch sits in the global batch: the MoE family's dispatch groups are the
global batch's.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba, moe, rwkv, transformer, vlm, whisper
from repro_torch.sharding import partition as P

__all__ = ["get_family", "init_params", "apply_train", "init_cache",
           "decode_step", "prefill_chunk", "supports_chunked_prefill",
           "loss_fn", "cross_entropy", "MOE_AUX_WEIGHT", "shards",
           "apply_train_sharded", "decode_step_sharded"]

# the families whose decode step takes ``donate``
_DONATING = ("dense", "moe", "vlm")

_FAMILIES = {
    "dense": transformer,
    "moe": moe,
    "vlm": vlm,
    "hybrid": mamba,
    "ssm": rwkv,
    "audio": whisper,
}

MOE_AUX_WEIGHT = 0.01


def get_family(cfg: ModelConfig):
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown model family {cfg.family!r}") from None


def init_params(cfg: ModelConfig, generator=None, device=None) -> dict:
    return get_family(cfg).init_params(cfg, generator, device)


def _zero_aux(logits: torch.Tensor):
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def apply_train(cfg: ModelConfig, params: dict, batch: dict, split=None):
    """The full-sequence forward -> (logits (B, S, V), aux loss): the MoE
    load-balance term (over the global batch's groups where ``split``
    says the batch is a rank's part of it), a float32 zero for the other
    families."""
    if cfg.family == "moe":
        return moe.forward(cfg, params, batch, split)
    out = get_family(cfg).forward(cfg, params, batch)
    if isinstance(out, tuple):
        return out
    return _zero_aux(out)


def shards(cfg: ModelConfig, mesh) -> bool:
    """True when the sharded train, prefill and decode steps keep
    ``cfg``'s params at their shards on ``mesh``: the ``model`` axis
    divides every dim the family splits on it (its module's
    ``tp_widths``).  Else they gather the params first."""
    tp = P.mesh_axis_size(mesh, "model")
    return all(w % tp == 0 for w in get_family(cfg).tp_widths(cfg))


def apply_train_sharded(cfg: ModelConfig, params: dict, batch: dict, layout,
                        split=None):
    """``apply_train`` on this rank's shards (``params`` the local tensors
    of a tree placed by ``layout``, ``batch`` this rank's part of the
    batch): (this rank's logits (B_local, S, V / model), aux loss)."""
    if cfg.family == "moe":
        return moe.forward_sharded(cfg, params, batch, layout, split)
    return _zero_aux(get_family(cfg).forward_sharded(cfg, params, batch,
                                                     layout))


def decode_step_sharded(cfg: ModelConfig, params: dict, cache: dict,
                        batch: dict, playout, clayout, donate: bool = True):
    """``decode_step`` as tensor-parallel products on this rank's shards
    of params and cache (placed by ``playout`` / ``clayout``) and its
    tokens (B_local, 1) -> (logits, the new local cache, the logits'
    spec).  The logits are this rank's piece of the whole batch's: where
    the vocab is split (the embedding or lm_head on (``data``,
    ``model``)), its V shard for the rows gathered along the batch axes
    that split the vocab too; else all of V for its local rows.  The
    spec (rows, None, vocab) names the axes along which the pieces
    differ (``serve_step.make_serve_step`` gathers along them)."""
    return get_family(cfg).decode_step_sharded(cfg, params, cache, batch,
                                               playout, clayout, donate)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device=None) -> dict:
    return get_family(cfg).init_cache(cfg, batch_size, max_len, device)


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict,
                donate: bool = False):
    """One decode step -> (logits (B, 1, V), the new cache).  ``donate``
    gives the cache up to the step: the decoder families' steps
    (``_DONATING``) may then write its K / V leaves in place
    (``transformer.decode_step``); the others return new leaves either
    way."""
    if donate and cfg.family in _DONATING:
        return get_family(cfg).decode_step(cfg, params, cache, batch, True)
    return get_family(cfg).decode_step(cfg, params, cache, batch)


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """True when the family prefills C tokens per call (dense, hybrid,
    ssm); the others prefill by token replay in the engine."""
    return hasattr(get_family(cfg), "prefill_chunk")


def prefill_chunk(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    """Chunked prefill: batch["tokens"] (B, C) lands at cache["len"].. and
    only batch["n_valid"] leading tokens are real.  Returns full-chunk
    logits (B, C, V) and the updated cache (len advanced by n_valid)."""
    mod = get_family(cfg)
    if not hasattr(mod, "prefill_chunk"):
        raise NotImplementedError(
            f"family {cfg.family!r} has no chunked prefill; use token "
            "replay")
    return mod.prefill_chunk(cfg, params, cache, batch)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  mesh=None) -> torch.Tensor:
    """Token-mean cross-entropy in float32: logits (B, S, V), labels
    (B, S) int, an optional ``mask`` (B, S) weighting each token (the
    padded vocab columns take part in the logsumexp, as the
    reference's).  With a ``mesh`` whose ``model`` axis splits the
    vocab, ``logits`` are this rank's shard and the form is
    vocab-parallel: the local max, all-reduced (max); the local sum of
    exp, all-reduced (sum); the gold logit from the rank that holds it."""
    logits = logits.float()
    if mesh is None or P.mesh_axis_size(mesh, "model") == 1:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, labels.long()[..., None],
                                    dim=-1)[..., 0]
    else:
        n = logits.shape[-1]
        m = P.all_reduce(logits.detach().amax(dim=-1), mesh, "model", "max")
        sumexp = torch.exp(logits - m[..., None]).sum(dim=-1)
        logz = m + torch.log(P.reduce_from(sumexp, mesh))
        idx = labels.long() - P.axis_index(mesh, "model") * n
        own = (idx >= 0) & (idx < n)
        gold = torch.take_along_dim(
            logits, torch.where(own, idx, torch.zeros_like(idx))[..., None],
            dim=-1)[..., 0]
        gold = P.reduce_from(torch.where(own, gold, torch.zeros_like(gold)),
                             mesh)
    nll = logz - gold
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, layout=None,
            split=None):
    """-> (loss, {"ce", "aux"}): the cross-entropy of ``apply_train``'s
    logits against ``batch["labels"]`` (``batch["loss_mask"]`` when given)
    plus ``MOE_AUX_WEIGHT`` times the aux term (zero outside MoE).  With
    a ``layout`` (``partition.Layout``) ``params`` are this rank's shards:
    ``apply_train_sharded`` and the vocab-parallel cross-entropy
    (where ``shards``).  ``split``: ``batch`` is this rank's
    part of the global batch (``moe.Split``)."""
    if layout is None:
        logits, aux = apply_train(cfg, params, batch, split)
        mesh = None
    else:
        logits, aux = apply_train_sharded(cfg, params, batch, layout, split)
        mesh = layout.mesh
    labels = batch["labels"].to(logits.device)
    mask = batch.get("loss_mask")
    ce = cross_entropy(logits, labels,
                       None if mask is None else mask.to(logits.device), mesh)
    loss = ce + MOE_AUX_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux}
