"""Family dispatch (mirrors ``src/repro/models/factory.py``): one model API
over the six families.

  init_params(cfg, generator, device) -> params dict (stacked layers)
  apply_train(cfg, params, batch)     -> (logits, aux_loss)
  init_cache(cfg, B, max_len, device) -> decode cache dict
  decode_step(cfg, params, cache, batch) -> (logits, cache)
  prefill_chunk(cfg, params, cache, batch) -> (logits, cache)
  loss_fn(cfg, params, batch)         -> (loss, metrics)
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba, moe, rwkv, transformer, vlm, whisper

__all__ = ["get_family", "init_params", "apply_train", "init_cache",
           "decode_step", "prefill_chunk", "supports_chunked_prefill",
           "loss_fn", "cross_entropy", "MOE_AUX_WEIGHT"]

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


def apply_train(cfg: ModelConfig, params: dict, batch: dict):
    """The full-sequence forward -> (logits (B, S, V), aux loss): the MoE
    load-balance term, a float32 zero for the other families."""
    out = get_family(cfg).forward(cfg, params, batch)
    if isinstance(out, tuple):
        return out
    return out, torch.zeros((), dtype=torch.float32, device=out.device)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device=None) -> dict:
    return get_family(cfg).init_cache(cfg, batch_size, max_len, device)


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
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
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean cross-entropy in float32: logits (B, S, V), labels
    (B, S) int, an optional ``mask`` (B, S) weighting each token (the
    padded vocab columns take part in the logsumexp, as the
    reference's)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.long()[..., None],
                                dim=-1)[..., 0]
    nll = logz - gold
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """-> (loss, {"ce", "aux"}): the cross-entropy of ``apply_train``'s
    logits against ``batch["labels"]`` (``batch["loss_mask"]`` when given)
    plus ``MOE_AUX_WEIGHT`` times the aux term (zero outside MoE)."""
    logits, aux = apply_train(cfg, params, batch)
    labels = batch["labels"].to(logits.device)
    mask = batch.get("loss_mask")
    ce = cross_entropy(logits, labels,
                       None if mask is None else mask.to(logits.device))
    loss = ce + MOE_AUX_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux}
