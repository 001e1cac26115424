"""Observability for the port's serving stack, the same modules as the
JAX package's ``telemetry``:

* ``trace``   — nested span tracer in the device trace's time base
  (Unix-epoch ns, as ``torch.profiler`` stamps its events; host time
  only, no synchronise) with Perfetto/Chrome and JSONL exporters, span
  coverage and the per-phase breakdown schema;
* ``metrics`` — counters / gauges / log-bucket histograms, snapshots and
  the Prometheus text format;
* ``profile`` — kernel launch profiling (warm-up discard, best/p50/p95
  on the device clock for CUDA outputs, effective GB/s);
* ``flightrec`` — the always-on ring of recent request and fault events;
* ``timeline`` — per-request lifecycles folded from a trace;
* ``regression`` — the noise-aware perf-regression sentinel.
"""
from repro_torch.telemetry.flightrec import (FlightRecorder,  # noqa: F401
                                             get_recorder, set_recorder)
from repro_torch.telemetry.metrics import (Counter, Gauge,  # noqa: F401
                                           Histogram, LATENCY_BUCKETS_S,
                                           REQUIRED_SERVE_METRICS,
                                           Registry, THROUGHPUT_BUCKETS,
                                           US_BUCKETS, log_buckets,
                                           validate_snapshot)
from repro_torch.telemetry.profile import (KernelProfiler,  # noqa: F401
                                           LaunchTiming, time_launch)
from repro_torch.telemetry.regression import (MetricSpec,  # noqa: F401
                                              PerfRegressionError,
                                              assert_no_regression, compare,
                                              format_findings)
from repro_torch.telemetry.timeline import (RequestTimeline,  # noqa: F401
                                            Segment, build_timelines,
                                            check_timelines,
                                            format_timeline,
                                            timelines_from_chrome,
                                            timelines_from_jsonl,
                                            timelines_from_tracer)
from repro_torch.telemetry.trace import (BREAKDOWN_SCHEMA_KEYS,  # noqa: F401
                                         NULL_TRACER, Span, Tracer,
                                         get_tracer, phase_breakdown,
                                         set_tracer, span_coverage,
                                         validate_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "log_buckets",
    "LATENCY_BUCKETS_S", "THROUGHPUT_BUCKETS", "US_BUCKETS",
    "REQUIRED_SERVE_METRICS", "validate_snapshot",
    "KernelProfiler", "LaunchTiming", "time_launch",
    "Span", "Tracer", "NULL_TRACER", "get_tracer", "set_tracer",
    "span_coverage", "phase_breakdown", "validate_chrome_trace",
    "BREAKDOWN_SCHEMA_KEYS",
    "FlightRecorder", "get_recorder", "set_recorder",
    "Segment", "RequestTimeline", "build_timelines",
    "timelines_from_tracer", "timelines_from_chrome",
    "timelines_from_jsonl", "check_timelines", "format_timeline",
    "MetricSpec", "PerfRegressionError", "compare",
    "assert_no_regression", "format_findings",
]
