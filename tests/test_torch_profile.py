"""The port's launch profiler (``repro_torch.telemetry.profile``) against
the JAX package's: warm-up discard, ``LaunchTiming.to_dict()`` keys (the
reference's plus ``clock``), ``KernelProfiler.report()`` keys for the
same calls, and equal best/p50/p95/mean from the same observations.  On
the CPU every sample is on the host clock; the device clock (CUDA events
around CUDA-graph replays) runs on the card in ``chip_smoke.py``'s
autotune phase."""
import time

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.telemetry import profile as RP  # noqa: E402

from repro_torch.telemetry import profile as PP  # noqa: E402


class _FakeTime:
    """A ``time`` stand-in whose ``perf_counter`` advances by the given
    microsecond durations, one per (start, stop) pair."""

    def __init__(self, durations_us):
        self._ticks = []
        t = 0.0
        for d in durations_us:
            self._ticks += [t, t + d * 1e-6]
            t += d * 1e-6 + 1.0
        self._ticks.reverse()

    def perf_counter(self):
        return self._ticks.pop()


def test_time_launch_discards_its_warmup():
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= 2:          # the warm-up calls: a slow first use
            time.sleep(0.05)
        return torch.zeros(4)

    t = PP.time_launch(fn, iters=3, warmup=2)
    assert len(calls) == 5
    assert (t.iters, t.warmup, t.clock) == (3, 2, "host")
    assert t.best_us <= t.p50_us <= t.p95_us
    assert t.p95_us < 40e3, "a warm-up call landed in a timed sample"


def test_time_launch_takes_at_least_one_warmup_and_checks_its_args():
    calls = []
    t = PP.time_launch(lambda: calls.append(1), iters=2, warmup=0)
    assert len(calls) == 3 and t.warmup == 1
    for kw in ({"iters": 0}, {"warmup": -1}, {"reps": 0}):
        with pytest.raises(ValueError):
            PP.time_launch(lambda: None, **kw)


@pytest.mark.parametrize("extra", [{}, {"bytes_moved": 4096},
                                   {"bytes_moved": 4096, "dense_bytes": 8192,
                                    "dense_us": 10.0}],
                         ids=["plain", "bytes", "roofline"])
def test_launch_timing_dict_has_the_reference_keys_plus_clock(extra):
    want = RP.time_launch(lambda: jnp.zeros(4), iters=2, **extra).to_dict()
    got = PP.time_launch(lambda: torch.zeros(4), iters=2, **extra).to_dict()
    assert list(got) == list(want) + ["clock"]
    assert got["clock"] == "host"


def test_kernel_profiler_report_keys_match_the_reference():
    rp, pp = RP.KernelProfiler(), PP.KernelProfiler()
    calls = [dict(shape="4096x11008", impl="ref", quant="int8", B=4),
             dict(shape="4096x11008", impl="ref", quant="fp", B=1),
             dict(shape="12288x4096", quant="int4", B=8)]
    for kw in calls:
        rp.profile(lambda: jnp.ones(8), iters=2, **kw)
        pp.profile(lambda: torch.ones(8), iters=2, **kw)
    want, got = rp.report(), pp.report()
    assert list(got) == list(want)
    for k in want:
        assert list(got[k]) == list(want[k]) + ["clock"]


@pytest.mark.parametrize("durations", [[3.0, 7.0, 5.0, 120.0, 9.0, 11.0],
                                       [50.0, 50.0, 51.0, 49.5, 52.5],
                                       [0.4, 1e4, 12.0]],
                         ids=["spread", "tight", "outlier"])
def test_same_observations_give_equal_quantiles(durations, monkeypatch):
    """Both packages time ``len(durations)`` calls (one warm-up, untimed)
    against the same fake clock: best, p50, p95 and mean agree."""
    monkeypatch.setattr(RP, "time", _FakeTime(durations))
    monkeypatch.setattr(PP, "time", _FakeTime(durations))
    n = len(durations)
    want = RP.time_launch(lambda: jnp.zeros(2), iters=n, warmup=1)
    got = PP.time_launch(lambda: torch.zeros(2), iters=n, warmup=1)
    assert got.best_us == pytest.approx(min(durations))
    for f in ("best_us", "p50_us", "p95_us", "mean_us"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12)


def test_time_launch_spans_each_warmup_and_sample():
    from repro_torch.telemetry.trace import Tracer
    tr = Tracer(enabled=True)
    PP.time_launch(lambda: torch.zeros(2), iters=3, warmup=2, tracer=tr,
                   label="k")
    cats = [s.cat for s in tr.spans("k")]
    assert sorted(cats) == ["timed"] * 3 + ["warmup"] * 2
