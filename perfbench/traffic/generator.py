"""The one traffic generator: reads a mix file ``traffic/<mix>.json`` and
turns it, with a run's seed, into the stream of requests its clients send.

A mix fixes a pool of (prompt length, output length) pairs: ``pool``
evenly spaced quantiles of each length's distribution, paired by a
permutation drawn from the mix's own ``pool_seed``.  Every run seed sends
that same set of sizes, in its own order: pass p of the stream is a
permutation of the pool drawn from (seed, p).  Request k's token ids are
drawn from (seed, k) alone, uniform over the vocabulary, so a request's
content never depends on timing.

Mix keys:

- ``loop``: how requests are sent, the module ``traffic/loops/<loop>.py``
  (``closed``: each client sends its next request as soon as its previous
  one completes; ``open``: requests arrive at the times of a fixed pool
  of gaps, whoever waits);
- ``clients``: the closed loop's clients, or the requests an open loop
  sends at once to warm up;
- ``pool``, ``pool_seed``: the size set, as above;
- ``prompt_len`` / ``output_len``: a length distribution, the module
  ``traffic/lengths/<dist>.py`` named by its ``dist`` key, with that
  module's parameters;
- ``max_total``: prompt + output never exceeds it (outputs are cut);
- ``ramp_ticks``: engine ticks the loop runs before the window opens;
- ``engine``: the serving engine's settings for this mix;
- ``source``: where the mix's numbers come from (read by people only).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from perfbench.harness.plugins import BENCH_DIR, load_module

__all__ = ["load_mix", "pool_sizes", "RequestStream", "seed_words"]

_PASS, _IDS = 1, 2          # seed-sequence tags of the two draws


def load_mix(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The mix file ``<bench_dir>/traffic/<name>.json``."""
    path = Path(bench_dir) / "traffic" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix file {path}")
    mix = json.loads(path.read_text())
    for key in ("loop", "pool", "pool_seed", "prompt_len", "output_len",
                "max_total", "engine"):
        if key not in mix:
            raise ValueError(f"mix {name!r} has no {key!r}")
    return mix


def _lengths(spec: dict, n: int, bench_dir: Path) -> list:
    return load_module("traffic/lengths", spec["dist"],
                       bench_dir).quantiles(spec, n)


def pool_sizes(mix: dict, bench_dir: Path = BENCH_DIR) -> list:
    """The mix's fixed [(prompt length, output length)] pool."""
    n = int(mix["pool"])
    prompts = _lengths(mix["prompt_len"], n, bench_dir)
    outputs = _lengths(mix["output_len"], n, bench_dir)
    pair = np.random.default_rng(int(mix["pool_seed"])).permutation(n)
    cap = int(mix["max_total"])
    return [(p, max(1, min(outputs[j], cap - p)))
            for p, j in zip(prompts, pair.tolist())]


def seed_words(seed: int) -> list:
    """A run seed of any size as two 32-bit words of a seed sequence."""
    s = int(seed) % 2 ** 64
    return [s & 0xFFFFFFFF, s >> 32]


class RequestStream:
    """Request k of a run: ``spec(k)`` -> (prompt ids, output length).
    The k-th request sent in the run is request k, whichever client
    sends it."""

    def __init__(self, mix: dict, seed: int, vocab: int,
                 bench_dir: Path = BENCH_DIR):
        self.sizes = pool_sizes(mix, bench_dir)
        self.seed = seed_words(seed)
        self.vocab = int(vocab)
        self._order: dict = {}

    def _size(self, k: int) -> tuple:
        n = len(self.sizes)
        p, i = divmod(k, n)
        order = self._order.get(p)
        if order is None:
            rng = np.random.default_rng(self.seed + [_PASS, p])
            order = self._order[p] = rng.permutation(n).tolist()
        return self.sizes[order[i]]

    def spec(self, k: int) -> tuple:
        plen, out = self._size(k)
        rng = np.random.default_rng(self.seed + [_IDS, k])
        ids = rng.integers(0, self.vocab, size=plen, dtype=np.int64)
        return ids.tolist(), out
