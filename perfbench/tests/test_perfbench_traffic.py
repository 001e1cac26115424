"""The traffic generator: a seed repeats its stream exactly, seeds differ
in order and content but send the same set of sizes."""
from __future__ import annotations

import collections

import numpy as np
import pytest

from perfbench.harness.manifest import load_manifest
from perfbench.traffic.generator import RequestStream, load_mix, pool_sizes

MIXES = sorted({w["traffic"] for w in load_manifest()["workloads"]})
VOCAB = 49155
BIG_SEED = 2 ** 31 + 12345


def _stream(mix, seed, n):
    s = RequestStream(mix, seed, VOCAB)
    return [s.spec(k) for k in range(n)]


@pytest.mark.parametrize("name", MIXES)
def test_a_seed_repeats_exactly(name):
    mix = load_mix(name)
    n = 2 * int(mix["pool"]) + 3
    assert _stream(mix, BIG_SEED, n) == _stream(mix, BIG_SEED, n)


@pytest.mark.parametrize("name", MIXES)
def test_seeds_differ_but_send_the_same_sizes(name):
    mix = load_mix(name)
    n = int(mix["pool"])
    a, b = _stream(mix, BIG_SEED, n), _stream(mix, 7, n)
    assert a != b
    sizes = collections.Counter((len(p), o) for p, o in a)
    assert sizes == collections.Counter((len(p), o) for p, o in b)
    assert sizes == collections.Counter(pool_sizes(mix))


@pytest.mark.parametrize("name", MIXES)
def test_sizes_keep_the_mix_limits(name):
    mix = load_mix(name)
    pl, ol = mix["prompt_len"], mix["output_len"]
    for p, o in pool_sizes(mix):
        assert pl["min"] <= p <= pl["max"]
        assert 1 <= o <= ol["max"]
        assert p + o <= mix["max_total"] < mix["engine"]["max_len"]
    for prompt, _ in _stream(mix, BIG_SEED, 8):
        assert all(0 <= t < VOCAB for t in prompt)


def test_uniform_lengths_cover_their_range():
    from perfbench.harness.plugins import load_module
    uniform = load_module("traffic/lengths", "uniform")
    spec = {"dist": "uniform", "min": 16, "max": 48}
    xs = uniform.quantiles(spec, 33)
    assert xs == list(range(16, 49))
    assert uniform.quantiles(spec, 4) == [20, 28, 36, 44]


def test_open_loop_gaps_repeat_per_seed_and_keep_their_rate():
    from perfbench.harness.plugins import load_module
    open_loop = load_module("traffic/loops", "open")
    arrivals = {"rate_per_s": 5.0, "cv": 1.0, "pool": 4000}
    gaps = open_loop.gap_pool(arrivals, 3)
    assert gaps == open_loop.gap_pool(arrivals, 3)
    assert abs(np.mean(gaps) - 0.2) < 0.01
    assert abs(np.std(gaps) / np.mean(gaps) - 1.0) < 0.05
    bursty = open_loop.gap_pool(dict(arrivals, cv=3.0), 3)
    assert np.std(bursty) / np.mean(bursty) > 2.5
