"""The serving step: one decode step (dense, or through the ESPIM packs) +
greedy/temperature sampling, and the full-sequence prefill forward
(mirrors ``src/repro/serve/serve_step.py``), and the decode step on a
device mesh (``make_serve_step``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import sparse_model
from repro_torch.models import factory
from repro_torch.sharding import partition
from repro_torch.telemetry.trace import get_tracer
from repro_torch.tree import tree_map

__all__ = ["sample_tokens", "serve_step_fn", "serve_step_sparse_fn",
           "prefill_fn", "make_serve_step"]


def sample_tokens(cfg: ModelConfig, last: torch.Tensor, temperature: float,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Greedy/temperature sampling over one position's logits (B, V),
    vocab padding masked.  Returns (B,) int32.  Temperature sampling
    draws from the caller's ``generator`` (on the logits' device); torch
    cannot replay jax.random, so only greedy tokens compare across the
    two packages.  Traced as ``sample``."""
    with get_tracer().span("sample", cat="forward"):
        last = last.float()
        if cfg.padded_vocab != cfg.vocab_size:
            last = last.clone()
            last[:, cfg.vocab_size:] = -1e30
        if temperature > 0.0:
            probs = torch.softmax(last / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(last, dim=-1)
        return nxt.to(torch.int32)


def serve_step_fn(cfg: ModelConfig, params: dict, cache: dict, batch: dict,
                  temperature: float = 0.0,
                  generator: torch.Generator | None = None,
                  donate: bool = False):
    """Dense decode step -> (next_tokens (B, 1), logits (B, 1, V),
    new_cache); runs where ``params`` live (``donate`` as
    ``factory.decode_step``)."""
    logits, cache = factory.decode_step(cfg, params, cache, batch, donate)
    nxt = sample_tokens(cfg, logits[:, -1, :], temperature, generator)
    return nxt[:, None], logits, cache


def serve_step_sparse_fn(cfg: ModelConfig, params: dict, sparse: dict,
                         cache: dict, batch: dict, temperature: float = 0.0,
                         impl: str | None = None,
                         generator: torch.Generator | None = None,
                         device=None, donate: bool = False):
    """ESPIM-format decode step -> (next_tokens (B, 1), logits (B, 1, V),
    new_cache); every covered projection runs through the packed
    kernels (``donate`` as ``sparse_model.decode_step_sparse``)."""
    logits, cache = sparse_model.decode_step_sparse(
        cfg, params, sparse, cache, batch, impl=impl, device=device,
        donate=donate)
    nxt = sample_tokens(cfg, logits[:, -1, :], temperature, generator)
    return nxt[:, None], logits, cache


def prefill_fn(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V): the prefill shape, on
    ``layers.flash_attention`` (kernel 8 on the card).  The serving TTFT
    path runs ``factory.prefill_chunk`` or token replay instead."""
    logits, _ = factory.apply_train(cfg, params, batch)
    return logits


def make_serve_step(cfg: ModelConfig, mesh, params_shapes, cache_shapes,
                    batch_shapes, donate_cache: bool = True):
    """The dense decode step on a ``DeviceMesh`` -> (step, pspecs, cspecs,
    bspecs): the serve, cache and batch specs of the given shape trees.
    ``step(params, cache, batch)`` takes them as DTensors placed by those
    specs and returns (next_tokens (B, 1), logits (B, 1, V), the new
    cache placed as the input's), the tokens and logits of the whole
    batch on every rank.

    Where ``factory.shards`` (every family, on a mesh whose ``model``
    axis divides its tensor-parallel widths) params and cache stay at
    their shards: each rank decodes its part of the batch as
    tensor-parallel products (``factory.decode_step_sharded``: no param
    leaf gathered; each product on the rank's weight shard, the
    activations gathered along the batch axes where a weight dim splits
    over them and the partial products summed back to the local batch;
    attention on the local KV heads or positions, a sequence split over
    ranks combined by partial-softmax all-reduces; a MoE layer's experts
    on ``model`` and their F dim on ``data`` over the whole decode
    group; zamba2's SSM state and rwkv6's WKV state updated on their own
    slices), then the logits are gathered: their vocab shards where the
    vocab is split, else the batch.
    With ``donate_cache`` (the reference's donated cache) the cache's
    K / V leaves are updated in place and returned (``len`` is a new
    tensor).  Elsewhere the step runs ``serve_step_fn`` on the full
    values of params, cache and batch on every rank and places the new
    cache by ``cspecs``.  At world size 1 both are ``serve_step_fn`` bit
    for bit."""
    from torch.distributed.tensor import DTensor

    pspecs = partition.serve_param_pspecs(params_shapes, mesh)
    cspecs = partition.cache_pspecs(cache_shapes, mesh)
    bspecs = partition.batch_pspecs(batch_shapes, mesh)

    def local(tree):
        return tree_map(lambda t: t.to_local(), tree)

    @torch.no_grad()
    def sharded(params: dict, cache: dict, batch: dict):
        logits, new, lspec = factory.decode_step_sharded(
            cfg, local(params), local(cache), local(batch),
            partition.Layout.of(params), partition.Layout.of(cache),
            donate_cache)
        logits = partition.gather_along(logits, lspec, mesh,
                                        mesh.mesh_dim_names)
        nxt = sample_tokens(cfg, logits[:, -1, :], 0.0)
        out = {k: v if donate_cache and k != "len" else DTensor.from_local(
            new[k], mesh, v.placements, run_check=False)
            for k, v in cache.items()}
        return nxt[:, None], logits, out

    @torch.no_grad()
    def gathered(params: dict, cache: dict, batch: dict):
        full = tree_map(partition.full_value, [params, cache, batch])
        nxt, logits, new = serve_step_fn(cfg, *full)
        return nxt, logits, partition.logical_to_sharding(new, cspecs, mesh)

    step = sharded if factory.shards(cfg, mesh) else gathered
    return step, pspecs, cspecs, bspecs
