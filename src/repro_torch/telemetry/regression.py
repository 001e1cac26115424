"""Noise-aware perf-regression sentinel (DESIGN.md §14).

The bench artifacts (``BENCH_*.json``) record headline metrics with
repeat statistics (best / p50 / p95 from interleaved round-robin
repeats), but until this module nothing *gated* on them — a kernel
regression only surfaced when a human eyeballed the JSON.  The sentinel
compares an observed bench run against a checked-in baseline with
tolerance semantics that match how each metric can legitimately move:

* ``exact``         — determinism invariants (bytes/token, bits/nnz):
  the value is a function of the pack geometry, not the host, so any
  drift beyond float slop is a real change.  ``rel_tol`` is 0 (or tiny).
* ``higher_better`` — throughput.  Host noise moves timing runs both
  ways, so the bound is one-sided and windowed: observed must stay
  above ``baseline.lo / (1 + rel_tol)`` where ``lo`` is the baseline's
  p50 (its *pessimistic* side).  A generous ``rel_tol`` (~2.0, i.e. a
  3x band) keeps CI quiet across machines while still catching the
  order-of-magnitude cliffs that matter (a dropped fusion, an
  accidental dense fallback, a host sync in the decode loop).
* ``lower_better``  — latency (TTFT/TPOT p95, µs/call).  Observed must
  stay below ``baseline.hi * (1 + rel_tol)`` where ``hi`` is the
  baseline's p95.

Baselines are plain dicts ``{metric: {"value", "lo", "hi"}}`` (see
``benchmarks/bench_history.py`` for extraction from bench docs); the
metric *policy* (kind + tolerance) lives in code so tightening a band
never requires regenerating baselines.  A metric present in the
baseline but missing from the observed run is itself a failure — a
silently dropped bench section must not pass the gate.
"""
from __future__ import annotations

import dataclasses

__all__ = ["MetricSpec", "PerfRegressionError", "compare",
           "format_findings", "assert_no_regression"]

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    key: str
    kind: str            # "exact" | "higher_better" | "lower_better"
    rel_tol: float = 0.0

    def __post_init__(self):
        if self.kind not in ("exact", "higher_better", "lower_better"):
            raise ValueError(f"unknown metric kind {self.kind!r}")
        if self.rel_tol < 0:
            raise ValueError("rel_tol must be >= 0")


class PerfRegressionError(AssertionError):
    """Raised by ``assert_no_regression``; carries the findings list."""

    def __init__(self, message: str, findings: list):
        super().__init__(message)
        self.findings = findings


def _entry(raw) -> dict:
    """Normalize a baseline entry: bare numbers mean a degenerate
    window (value == lo == hi)."""
    if isinstance(raw, dict):
        v = float(raw["value"])
        return {"value": v, "lo": float(raw.get("lo", v)),
                "hi": float(raw.get("hi", v))}
    v = float(raw)
    return {"value": v, "lo": v, "hi": v}


def compare(baseline: dict, observed: dict, specs: list[MetricSpec]) -> list:
    """Evaluate every spec; returns one finding per metric:
    ``{"metric", "kind", "ok", "baseline", "observed", "bound",
    "rel_tol", "detail"}``.  Specs whose key is absent from the
    *baseline* are skipped (new metrics phase in by refreshing the
    baseline); absent from *observed* while present in baseline fails.
    """
    findings = []
    for spec in specs:
        if spec.key not in baseline:
            continue
        b = _entry(baseline[spec.key])
        if spec.key not in observed or observed[spec.key] is None:
            findings.append({
                "metric": spec.key, "kind": spec.kind, "ok": False,
                "baseline": b, "observed": None, "bound": None,
                "rel_tol": spec.rel_tol,
                "detail": "metric missing from observed run"})
            continue
        o = float(_entry(observed[spec.key])["value"]) \
            if isinstance(observed[spec.key], dict) \
            else float(observed[spec.key])
        if spec.kind == "exact":
            bound = spec.rel_tol * max(abs(b["value"]), _EPS)
            ok = abs(o - b["value"]) <= max(bound, _EPS)
            detail = (f"|{o:g} - {b['value']:g}| <= {max(bound, _EPS):g}"
                      if ok else
                      f"exact metric drifted: {b['value']:g} -> {o:g}")
        elif spec.kind == "higher_better":
            bound = b["lo"] / (1.0 + spec.rel_tol)
            ok = o >= bound
            detail = (f"{o:g} >= floor {bound:g}" if ok else
                      f"{o:g} fell below floor {bound:g} "
                      f"(baseline window [{b['lo']:g}, {b['hi']:g}])")
        else:  # lower_better
            bound = b["hi"] * (1.0 + spec.rel_tol)
            ok = o <= bound
            detail = (f"{o:g} <= ceiling {bound:g}" if ok else
                      f"{o:g} exceeded ceiling {bound:g} "
                      f"(baseline window [{b['lo']:g}, {b['hi']:g}])")
        findings.append({"metric": spec.key, "kind": spec.kind, "ok": ok,
                         "baseline": b, "observed": o, "bound": bound,
                         "rel_tol": spec.rel_tol, "detail": detail})
    return findings


def format_findings(findings: list, *, only_bad: bool = False) -> str:
    """Human-readable table — CI prints this on failure so the offending
    metric, its baseline window, and the observed value are in the log."""
    lines = []
    for f in findings:
        if only_bad and f["ok"]:
            continue
        mark = "ok  " if f["ok"] else "FAIL"
        b = f["baseline"]
        obs = "MISSING" if f["observed"] is None else f"{f['observed']:g}"
        lines.append(
            f"  [{mark}] {f['metric']} ({f['kind']}, rel_tol="
            f"{f['rel_tol']:g}): observed {obs} vs baseline "
            f"{b['value']:g} [{b['lo']:g}, {b['hi']:g}] — {f['detail']}")
    return "\n".join(lines)


def assert_no_regression(baseline: dict, observed: dict,
                         specs: list[MetricSpec],
                         *, label: str = "bench") -> list:
    """``compare`` + raise ``PerfRegressionError`` listing every failed
    metric (name, baseline window, observed value).  Returns the full
    findings list when everything passes."""
    findings = compare(baseline, observed, specs)
    bad = [f for f in findings if not f["ok"]]
    if bad:
        raise PerfRegressionError(
            f"perf regression in {label}: {len(bad)}/{len(findings)} "
            f"gated metric(s) out of band\n"
            + format_findings(bad), findings)
    return findings
