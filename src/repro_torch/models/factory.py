"""Family dispatch (mirrors ``src/repro/models/factory.py``): one model API
over the families the port serves.

  init_params(cfg, generator, device) -> params dict (stacked layers)
  init_cache(cfg, B, max_len, device) -> decode cache dict
  decode_step(cfg, params, cache, batch) -> (logits, cache)
  prefill_chunk(cfg, params, cache, batch) -> (logits, cache)

Only the dense family is ported; training's ``apply_train`` / ``loss_fn``
are not (ROADMAP Queue 1, "Training").
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

__all__ = ["get_family", "init_params", "init_cache", "decode_step",
           "prefill_chunk", "supports_chunked_prefill"]

_FAMILIES = {"dense": transformer}


def get_family(cfg: ModelConfig):
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported (ROADMAP Queue 1, "
            "'The other model families')") from None


def init_params(cfg: ModelConfig, generator=None, device=None) -> dict:
    return get_family(cfg).init_params(cfg, generator, device)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device=None) -> dict:
    return get_family(cfg).init_cache(cfg, batch_size, max_len, device)


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    return get_family(cfg).decode_step(cfg, params, cache, batch)


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """True when the family prefills C tokens per call."""
    return hasattr(get_family(cfg), "prefill_chunk")


def prefill_chunk(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    """Chunked prefill: batch["tokens"] (B, C) lands at cache["len"].. and
    only batch["n_valid"] leading tokens are real.  Returns full-chunk
    logits (B, C, V) and the updated cache (len advanced by n_valid)."""
    return get_family(cfg).prefill_chunk(cfg, params, cache, batch)
