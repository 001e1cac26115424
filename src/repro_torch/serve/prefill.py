"""Chunked prefill: C prompt tokens per call (mirrors
``src/repro/serve/prefill.py``).

The ESPIM engine runs the GEMM-shaped prefill chunk through the pruned
dense copies of every covered projection (``proj_path="dense"``), while
decode runs the packed SpMV kernels; the dense engine (``sparse=None``)
runs the family's ``prefill_chunk``.  Each slot prefills into a private
(B=1) scratch cache; after every chunk the freshly written K/V rows are
sliced out for the engine to splice into the slot's pages.  The scratch
cache starts from one shared zero prototype: the prefill step never
modifies its input cache, so "resetting" a slot's scratch is a reference
copy, not an allocation.  The final chunk also yields the recurrent
state leaves (ssm / conv / wkv / token-shift), which the engine installs
in the slot.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import sparse_model
from repro_torch.models import factory

__all__ = ["ChunkedPrefiller"]


class ChunkedPrefiller:
    def __init__(self, cfg: ModelConfig, chunk: int, max_len: int,
                 seq_names, state_names=(), sparse: dict | None = None,
                 impl: str | None = None, device=None):
        self.cfg = cfg
        self.chunk = chunk
        self.device = torch.device(device)
        # scratch length rounded up so the last chunk's pad rows fit
        self.scratch_len = -(-max_len // chunk) * chunk
        self.proto = factory.init_cache(cfg, 1, self.scratch_len,
                                        self.device)
        self.seq_names = list(seq_names)
        self.state_names = list(state_names)
        self.sparse = sparse
        self.impl = impl

    def n_valid(self, prompt, pos: int) -> int:
        """The prompt tokens of the chunk starting at ``pos``."""
        return min(self.chunk, len(prompt) - pos)

    def run_chunk(self, params, pf_cache, prompt, pos: int):
        """Prefill one chunk starting at ``pos``.  Returns (full-chunk
        logits (1, C, V), new scratch cache, n_valid)."""
        c = self.chunk
        n_valid = self.n_valid(prompt, pos)
        tokens = torch.zeros((1, c), dtype=torch.int32)
        tokens[0, :n_valid] = torch.as_tensor(prompt[pos:pos + n_valid])
        batch = {"tokens": tokens.to(self.device),
                 "n_valid": torch.tensor([n_valid], dtype=torch.int32,
                                         device=self.device)}
        if self.sparse is None:
            logits, pf_cache = factory.prefill_chunk(self.cfg, params,
                                                     pf_cache, batch)
        else:
            logits, pf_cache = sparse_model.prefill_chunk_sparse(
                self.cfg, params, self.sparse, pf_cache, batch,
                impl=self.impl, device=self.device)
        return logits, pf_cache, n_valid

    def chunk_rows(self, pf_cache: dict, pos: int) -> dict:
        """The K/V rows the chunk just wrote: {name: (Lx, C, ...)}."""
        return {n: pf_cache[n][:, 0, pos:pos + self.chunk]
                for n in self.seq_names}

    def state_rows(self, pf_cache: dict) -> dict:
        """The recurrent state leaves after the final chunk:
        {name: (Lx, ...)} with the B = 1 dim squeezed out."""
        return {n: pf_cache[n][:, 0] for n in self.state_names}
