"""Deterministic synthetic token pipeline with exact-resume semantics
(mirrors ``src/repro/data/pipeline.py``).

A batch is a pure function of (seed, step): resuming needs only the step
counter, and every data-parallel rank can slice its own shard of the
global batch.  The draws come from a CPU ``torch.Generator`` seeded from
both, so a batch has the same values on any device; they follow the
reference's distribution (the square of a uniform, times the vocab) but
not its numbers, since torch cannot replay ``jax.random`` — tests that
compare the two packages carry the reference's batches across.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device

__all__ = ["PipelineConfig", "SyntheticPipeline"]

@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    seed: int = 0
    vocab_size: int = 32000
    seq_len: int = 1024
    global_batch: int = 8


class SyntheticPipeline:
    """Zipf-ish synthetic LM stream; labels are the next tokens.  Batches
    land on ``device`` (``cuda`` unless named)."""

    def __init__(self, cfg: PipelineConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    @classmethod
    def for_model(cls, mcfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                  device=None) -> "SyntheticPipeline":
        return cls(PipelineConfig(seed=seed, vocab_size=mcfg.vocab_size,
                                  seq_len=shape.seq_len,
                                  global_batch=shape.global_batch), device)

    def batch_at(self, step: int) -> dict:
        """{"tokens", "labels"}: (global_batch, seq_len) int32."""
        c = self.cfg
        # the CPU generator keeps 32 bits of its seed: mix (seed, step)
        # into one word, not by shifts that it would drop
        word = np.random.SeedSequence([c.seed, int(step)]).generate_state(1)
        gen = torch.Generator().manual_seed(int(word[0]))
        # heavier-tailed than uniform: square a uniform draw
        u = torch.rand((c.global_batch, c.seq_len + 1), generator=gen)
        tokens = (torch.square(u) * c.vocab_size).to(torch.int32)
        tokens = torch.clamp(tokens, 0, c.vocab_size - 1).to(self.device)
        return {"tokens": tokens[:, :-1].contiguous(),
                "labels": tokens[:, 1:].contiguous()}

    # --- exact-resume state ------------------------------------------------
    def state(self, step: int) -> dict:
        return {"seed": self.cfg.seed, "step": int(step)}

    @classmethod
    def restore(cls, mcfg: ModelConfig, shape: ShapeConfig, state: dict,
                device=None):
        pipe = cls.for_model(mcfg, shape, seed=state["seed"], device=device)
        return pipe, state["step"]
