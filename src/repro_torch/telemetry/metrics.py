"""Metrics registry: counters, gauges, log-bucketed histograms (DESIGN §12).

Absorbs and extends the engine's ``EngineStats``: TTFT/TPOT/queue-delay
live in fixed log-spaced-bucket histograms (streaming p50/p95 in
O(buckets), not a full sort per summary — the PR 7 bugfix), bytes/token
is reported *by plane* (value vs index vs uncovered dense, straight from
``sparse_stats``), tokens and requests count by terminal state, and the
fault-tolerance ladder (quarantines / retries / verify failures /
leaked-block checks) is first-class.

Instruments are labeled; a ``Registry`` carries base labels
(model / impl / quant / attn) merged into every instrument.  Snapshots
are plain dicts (stable keys — CI validates a traced smoke run's
snapshot against ``REQUIRED_SERVE_METRICS``) and the whole registry
renders to Prometheus text exposition format.

Zero dependencies (stdlib only).
"""
from __future__ import annotations

import bisect
import math

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "log_buckets",
           "LATENCY_BUCKETS_S", "THROUGHPUT_BUCKETS", "US_BUCKETS",
           "REQUIRED_SERVE_METRICS", "validate_snapshot"]


def log_buckets(lo: float, hi: float, n: int) -> tuple[float, ...]:
    """n log-spaced upper-bound edges from lo to hi (inclusive).  Fixed
    at construction: observe() is one bisect, quantile() one O(n) scan."""
    if not (lo > 0 and hi > lo and n >= 2):
        raise ValueError(f"bad bucket spec lo={lo} hi={hi} n={n}")
    ratio = (hi / lo) ** (1.0 / (n - 1))
    return tuple(lo * ratio ** i for i in range(n))


# shared presets: ~9% resolution over 8-9 decades
LATENCY_BUCKETS_S = log_buckets(1e-6, 1e3, 240)      # 1us .. 1000s
US_BUCKETS = log_buckets(1e-1, 1e8, 240)             # 0.1us .. 100s (in us)
THROUGHPUT_BUCKETS = log_buckets(1e-2, 1e7, 240)     # tok/s etc.


class Counter:
    """Monotonic count.  ``inc`` only; negative increments are a bug."""
    __slots__ = ("name", "labels", "value")
    kind = "counter"

    def __init__(self, name, labels):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int | float = 1):
        if n < 0:
            raise ValueError(f"counter {self.name} decremented by {n}")
        self.value += n
        return self

    def snapshot(self):
        return self.value


class Gauge:
    """Point-in-time value (occupancy, fragmentation, bytes/token)."""
    __slots__ = ("name", "labels", "value")
    kind = "gauge"

    def __init__(self, name, labels):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)
        return self

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed log-spaced-bucket histogram with streaming quantiles.

    ``edges`` are upper bounds; one implicit +Inf overflow bucket.
    ``observe`` is O(log buckets) (bisect); ``quantile`` is O(buckets):
    walk the cumulative counts to the target rank, then log-interpolate
    inside the bucket.  Exact count/sum/min/max ride along so means and
    totals are not bucket-quantized.
    """
    __slots__ = ("name", "labels", "edges", "counts", "count", "sum",
                 "min", "max")
    kind = "histogram"

    def __init__(self, name, labels, edges=LATENCY_BUCKETS_S):
        self.name = name
        self.labels = labels
        self.edges = tuple(float(e) for e in edges)
        if list(self.edges) != sorted(self.edges):
            raise ValueError("histogram edges must be sorted")
        self.counts = [0] * (len(self.edges) + 1)   # [+Inf overflow]
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, x: float):
        x = float(x)
        self.counts[bisect.bisect_left(self.edges, x)] += 1
        self.count += 1
        self.sum += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)
        return self

    def reset(self) -> None:
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def quantile(self, q: float) -> float | None:
        """Streaming quantile estimate, O(buckets).  None when empty.
        Clamped to the exact observed [min, max] so tiny samples do not
        report a bucket edge outside the data."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q={q} outside [0, 1]")
        if self.count == 0:
            return None
        rank = q * (self.count - 1) + 1         # 1-based target rank
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                # log-interpolate within bucket i: edges[i-1] .. edges[i]
                lo = self.edges[i - 1] if i > 0 else (
                    self.edges[0] / (self.edges[1] / self.edges[0])
                    if len(self.edges) > 1 else self.edges[0])
                hi = self.edges[i] if i < len(self.edges) else self.max
                frac = (rank - cum) / c
                if lo > 0 and hi > 0:
                    est = lo * (hi / lo) ** frac
                else:
                    est = lo + (hi - lo) * frac
                return min(max(est, self.min), self.max)
            cum += c
        return self.max

    def percentile_summary(self, qs=(50, 95)) -> dict:
        return {f"p{q}": self.quantile(q / 100.0) for q in qs}

    def snapshot(self):
        out = {"count": self.count,
               "sum": self.sum,
               "min": None if self.count == 0 else self.min,
               "max": None if self.count == 0 else self.max,
               "mean": self.sum / self.count if self.count else None}
        out.update(self.percentile_summary())
        return out


def _label_key(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return "{" + inner + "}"


class Registry:
    """A named, labeled instrument store.

    ``base_labels`` (model / impl / quant / attn for the engine) merge
    into every instrument; per-call labels distinguish series under one
    metric name.  Getting an existing (name, labels) pair returns the
    same instrument — instruments are create-once, mutate-forever, so
    hot-path callers can hold direct references and skip the lookup.
    """

    def __init__(self, base_labels: dict | None = None):
        self.base_labels = dict(base_labels or {})
        self._metrics: dict[str, dict] = {}   # name -> {labelkey: inst}
        self._kinds: dict[str, str] = {}
        self._help: dict[str, str] = {}

    def _get(self, cls, name, help, labels, **kw):
        merged = {**self.base_labels, **labels}
        key = _label_key(merged)
        fam = self._metrics.setdefault(name, {})
        if key not in fam:
            if name in self._kinds and self._kinds[name] != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{self._kinds[name]}, not {cls.kind}")
            self._kinds[name] = cls.kind
            if help:
                self._help[name] = help
            fam[key] = cls(name, merged, **kw)
        return fam[key]

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets=LATENCY_BUCKETS_S, **labels) -> Histogram:
        return self._get(Histogram, name, help, labels, edges=buckets)

    # ------------------------------------------------------------ exporters
    def snapshot(self) -> dict:
        """{"metric_name{labels}": value-or-histogram-summary} — flat,
        deterministic key order, JSON-ready."""
        out = {}
        for name in sorted(self._metrics):
            for key in sorted(self._metrics[name]):
                out[name + key] = self._metrics[name][key].snapshot()
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format v0.0.4."""
        lines = []
        for name in sorted(self._metrics):
            kind = self._kinds[name]
            if name in self._help:
                lines.append(f"# HELP {name} {self._help[name]}")
            lines.append(f"# TYPE {name} {kind}")
            for key in sorted(self._metrics[name]):
                inst = self._metrics[name][key]
                if kind in ("counter", "gauge"):
                    lines.append(f"{name}{key} {_fmt(inst.value)}")
                    continue
                # histogram: cumulative le buckets + sum + count
                base = dict(inst.labels)
                cum = 0
                for edge, c in zip(inst.edges, inst.counts):
                    cum += c
                    lbl = _label_key({**base, "le": _fmt(edge)})
                    lines.append(f"{name}_bucket{lbl} {cum}")
                lbl = _label_key({**base, "le": "+Inf"})
                lines.append(f"{name}_bucket{lbl} {inst.count}")
                lines.append(f"{name}_sum{_label_key(base)} "
                             f"{_fmt(inst.sum)}")
                lines.append(f"{name}_count{_label_key(base)} {inst.count}")
        return "\n".join(lines) + "\n"


def _fmt(v) -> str:
    if isinstance(v, float):
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


# --------------------------------------------------------------------------
# The checked-in key list a traced serving run must emit (CI telemetry
# smoke): base metric names — label sets vary with the engine config, the
# *names* must not silently disappear when code paths are refactored.
REQUIRED_SERVE_METRICS = (
    "serve_ttft_seconds",
    "serve_tpot_seconds",
    "serve_queue_delay_seconds",
    "serve_step_seconds",
    "serve_requests_total",
    "serve_tokens_total",
    "serve_degraded_tokens_total",
    "serve_quarantines_total",
    "serve_retries_total",
    "serve_verify_failures_total",
    "serve_watchdog_flags_total",
    "serve_preempts_total",
    "serve_shed_total",
    "serve_restores_total",
    "serve_queue_depth",
    "serve_arena_headroom_blocks",
    "serve_arena_checks_total",
    "serve_arena_blocks",
    "serve_arena_occupancy",
    "serve_arena_fragmentation",
    "serve_slot_occupancy",
    "espim_bytes_per_token",
    "espim_pad_frac",
)


def validate_snapshot(snapshot: dict, required=REQUIRED_SERVE_METRICS,
                      sparse: bool = True) -> None:
    """Assert every required metric family appears in a snapshot.  The
    espim_* families only exist on a sparse engine."""
    have = set()
    for key in snapshot:
        have.add(key.split("{", 1)[0])
    need = [m for m in required
            if sparse or not m.startswith("espim_")]
    missing = [m for m in need if m not in have]
    if missing:
        raise AssertionError(
            f"metrics snapshot missing families {missing}; "
            f"present: {sorted(have)}")
