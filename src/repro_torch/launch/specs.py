"""Meta-tensor stand-ins for every input of a cell — the dry run's
contract (mirrors ``src/repro/launch/specs.py``, whose
``ShapeDtypeStruct``s these replace).

``input_specs`` returns, with **no memory allocated** (every leaf lives
on the ``meta`` device), for each (arch, shape) cell:
  train   -> the full train state + batch for ``train_step``
  prefill -> params + batch for ``prefill_fn``
  decode  -> params + KV cache + one-token batch for ``serve_step``
The leaves have the reference's names, shapes and dtypes.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import factory
from repro_torch.optim.adamw import OptConfig
from repro_torch.train import train_step as ts

__all__ = ["train_batch_specs", "prefill_batch_specs", "decode_batch_specs",
           "cache_specs", "params_specs", "state_specs", "input_specs"]

_META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=_META)


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _sds((b, s), torch.int32),
             "labels": _sds((b, s), torch.int32)}
    if cfg.family == "vlm":
        batch["embeddings"] = _sds((b, s, cfg.d_model), cfg.cdtype)
        batch["vis_mask"] = _sds((b, s), torch.bool)
        batch["positions3"] = _sds((3, b, s), torch.int32)
    if cfg.family == "audio":
        batch["frames"] = _sds((b, cfg.encoder_seq, cfg.d_model), cfg.cdtype)
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    batch = train_batch_specs(cfg, shape)
    batch.pop("labels")
    return batch


def decode_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    return {"tokens": _sds((shape.global_batch, 1), torch.int32)}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Decode cache at depth seq_len (the cache the new token attends
    to)."""
    return factory.init_cache(cfg, shape.global_batch, shape.seq_len,
                              device=_META)


def params_specs(cfg: ModelConfig) -> dict:
    return factory.init_params(cfg, None, _META)


def state_specs(cfg: ModelConfig, ocfg: OptConfig | None = None) -> dict:
    return ts.init_train_state(cfg, ocfg or OptConfig(), device=_META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                ocfg: OptConfig | None = None) -> dict:
    """Everything the cell's entry point consumes, as meta tensors."""
    if shape.kind == "train":
        return {"state": state_specs(cfg, ocfg),
                "batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": params_specs(cfg),
                "batch": prefill_batch_specs(cfg, shape)}
    if shape.kind == "decode":
        return {"params": params_specs(cfg),
                "cache": cache_specs(cfg, shape),
                "batch": decode_batch_specs(cfg, shape)}
    raise ValueError(f"unknown shape kind {shape.kind!r}")
