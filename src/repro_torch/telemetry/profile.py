"""Kernel launch profiling: the port's twin of the JAX package's
``telemetry/profile.py``, the one timing harness the autotuner and the
card's A/Bs share.

``time_launch`` runs a callable with explicit warm-up discard (the
warm-up calls are also the kernels' first use, so their ``nvcc`` build
falls there and never in a sample), records every timed sample into a
telemetry ``Histogram`` (fixed log-spaced buckets), and returns best /
p50 / p95 / mean microseconds plus — when the caller passes the pack's
streamed plane bytes — the effective GB/s the launch sustained and its
fraction of the dense roofline.

Which clock a sample comes from depends on where the callable's output
lies, and ``LaunchTiming.clock`` records it:

* ``"device"`` — the output is a CUDA tensor.  ``fn`` is captured ``reps`` times into one CUDA graph,
  and each sample is the CUDA-event time of one replay over ``reps``.
  Events around one eager launch would also count the host's Python
  launch path, which for a 7-12 µs SpMV launch takes about as long as
  the kernel, so every candidate would read alike.  A callable that
  cannot be captured raises, naming the reason: it never drops to the
  host clock unasked.
* ``"host"`` — any other output (a CPU tensor, a number, None):
  ``time.perf_counter`` around each call, after a device synchronise
  when CUDA is in use, as the reference fences with
  ``block_until_ready``.

``KernelProfiler`` accumulates launches keyed by (shape, impl, quant, B)
so a script can dump one per-kernel report.
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import nullcontext

import torch

from repro_torch.telemetry.metrics import US_BUCKETS, Histogram
from repro_torch.telemetry.trace import NULL_TRACER

__all__ = ["LaunchTiming", "time_launch", "KernelProfiler"]


@dataclasses.dataclass
class LaunchTiming:
    """One profiled launch site.  Times in microseconds; ``clock`` names
    where they were taken (``"device"`` or ``"host"``, see the module
    docstring)."""
    iters: int
    warmup: int
    best_us: float
    p50_us: float
    p95_us: float
    mean_us: float
    bytes_moved: int | None = None       # value+index plane bytes per call
    gbps_best: float | None = None       # bytes_moved at best_us
    roofline_frac: float | None = None   # vs dense GB/s on same device
    clock: str = "host"

    def to_dict(self) -> dict:
        d = {"iters": self.iters, "warmup": self.warmup,
             "best_us": round(self.best_us, 1),
             "p50_us": round(self.p50_us, 1),
             "p95_us": round(self.p95_us, 1),
             "mean_us": round(self.mean_us, 1)}
        if self.bytes_moved is not None:
            d["bytes_moved"] = int(self.bytes_moved)
            d["gbps_best"] = round(self.gbps_best, 3)
        if self.roofline_frac is not None:
            d["roofline_frac"] = round(self.roofline_frac, 3)
        d["clock"] = self.clock
        return d


def _cuda_live() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _fence() -> None:
    if _cuda_live():
        torch.cuda.synchronize()


def _device_samples(fn, args, iters: int, reps: int, tracer,
                    label: str) -> list:
    """µs per call of each of ``iters`` replays of a CUDA graph holding
    ``fn(*args)`` ``reps`` times."""
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn(*args)
    except RuntimeError as e:
        raise RuntimeError(
            f"time_launch({label!r}): the callable cannot be captured in a "
            f"CUDA graph, so its launches cannot be timed on the device "
            f"clock ({e}); make it capturable (no host synchronise, no "
            f"host read of a device value) or time it on the host") from e
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        with tracer.span(label, cat="timed"):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
        out.append(a.elapsed_time(b) * 1e3 / reps)
    del graph
    return out


def _host_samples(fn, args, iters: int, tracer, label: str) -> list:
    out = []
    for _ in range(iters):
        with tracer.span(label, cat="timed"):
            _fence()
            t0 = time.perf_counter()
            fn(*args)
            _fence()
            out.append((time.perf_counter() - t0) * 1e6)
    return out


def time_launch(fn, *args, iters: int = 5, warmup: int = 1,
                bytes_moved: int | None = None,
                dense_bytes: int | None = None,
                dense_us: float | None = None,
                tracer=NULL_TRACER, label: str = "launch",
                reps: int = 10) -> LaunchTiming:
    """Profile ``fn(*args)``: ``warmup`` discarded calls (at least one:
    the kernels' build and first launch), then ``iters`` timed samples.
    On the device clock (a CUDA output) a sample is one CUDA-graph replay
    of ``reps`` calls over ``reps``, timed by CUDA events; on the host
    clock it is one call between two ``time.perf_counter`` reads, fenced
    by a device synchronise when CUDA is in use.  Samples land in a
    log-bucket Histogram — p50/p95 are its streaming quantiles, ``best``
    is exact.

    ``bytes_moved`` (the pack's value+index plane bytes per call) turns
    the best time into effective GB/s; adding ``dense_bytes``+``dense_us``
    (the dense product on the same shapes) expresses it as a fraction of
    the dense roofline.
    """
    if iters < 1 or warmup < 0 or reps < 1:
        raise ValueError(f"bad iters={iters} warmup={warmup} reps={reps}")
    out = None
    # warm-up on a side stream, as CUDA-graph capture wants
    side = torch.cuda.Stream() if _cuda_live() else None
    if side is not None:
        side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side) if side is not None else nullcontext():
        for _ in range(max(1, warmup)):
            with tracer.span(label, cat="warmup"):
                out = fn(*args)
                _fence()
    if isinstance(out, torch.Tensor) and out.is_cuda:
        clock = "device"
        samples = _device_samples(fn, args, iters, reps, tracer, label)
    else:
        clock = "host"
        samples = _host_samples(fn, args, iters, tracer, label)
    hist = Histogram("launch_us", {}, edges=US_BUCKETS)
    for us in samples:
        hist.observe(us)
    best = min(samples)
    t = LaunchTiming(iters=iters, warmup=max(1, warmup), best_us=best,
                     p50_us=hist.quantile(0.50), p95_us=hist.quantile(0.95),
                     mean_us=hist.sum / hist.count, clock=clock)
    if bytes_moved is not None:
        t.bytes_moved = int(bytes_moved)
        t.gbps_best = bytes_moved / max(best * 1e-6, 1e-12) / 1e9
        if dense_bytes is not None and dense_us is not None and dense_us > 0:
            dense_gbps = dense_bytes / (dense_us * 1e-6) / 1e9
            t.roofline_frac = t.gbps_best / max(dense_gbps, 1e-12)
    return t


class KernelProfiler:
    """Accumulates launch profiles keyed by (shape, impl, quant, B)."""

    def __init__(self, tracer=NULL_TRACER):
        self.tracer = tracer
        self.records: dict[tuple, LaunchTiming] = {}

    def profile(self, fn, *args, shape: str, impl: str = "ref",
                quant: str = "fp", B: int = 1, **kw) -> LaunchTiming:
        key = (shape, impl, quant, B)
        t = time_launch(fn, *args, tracer=self.tracer,
                        label=f"kernel:{shape}/{quant}/B{B}", **kw)
        self.records[key] = t
        return t

    def report(self) -> dict:
        return {
            f"{shape}|impl={impl}|quant={quant}|B={b}": t.to_dict()
            for (shape, impl, quant, b), t in sorted(self.records.items())}
