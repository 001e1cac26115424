"""The port's perf-regression sentinel (``repro_torch.telemetry.regression``,
a copy of the JAX package's) against the reference: each case of the
reference's ``tests/test_regression.py`` tolerance semantics runs
through both packages, holds its assertions in each, and the two give
equal findings.  (The ``bench_history`` cases read ``benchmarks/``,
which this round does not port.)"""
import pytest

from repro.telemetry import regression as RREG

from repro_torch.telemetry import regression as PREG


def _spec_validation(M):
    with pytest.raises(ValueError):
        M.MetricSpec("x", "bigger_is_nicer")
    with pytest.raises(ValueError):
        M.MetricSpec("x", "exact", rel_tol=-0.1)
    return []


def _exact(M):
    specs = [M.MetricSpec("bytes", "exact")]
    base = {"bytes": 4096.0}
    out = [M.compare(base, {"bytes": 4096.0}, specs)[0]]
    assert out[-1]["ok"]
    out.append(M.compare(base, {"bytes": 4097.0}, specs)[0])
    assert not out[-1]["ok"] and "drifted" in out[-1]["detail"]
    specs = [M.MetricSpec("bytes", "exact", rel_tol=1e-6)]
    out.append(M.compare(base, {"bytes": 4096.001}, specs)[0])
    assert out[-1]["ok"]
    out.append(M.compare(base, {"bytes": 4100.0}, specs)[0])
    assert not out[-1]["ok"]
    return out


def _higher_better(M):
    specs = [M.MetricSpec("tok_s", "higher_better", rel_tol=2.0)]
    base = {"tok_s": {"value": 100.0, "lo": 90.0, "hi": 110.0}}
    ok = M.compare(base, {"tok_s": 31.0}, specs)[0]
    assert ok["ok"]
    f = M.compare(base, {"tok_s": 29.0}, specs)[0]
    assert not f["ok"] and f["bound"] == pytest.approx(30.0)
    assert "[90, 110]" in f["detail"]
    return [ok, f]


def _lower_better(M):
    specs = [M.MetricSpec("ttft", "lower_better", rel_tol=2.0)]
    base = {"ttft": {"value": 0.15, "lo": 0.1, "hi": 0.2}}
    ok = M.compare(base, {"ttft": 0.59}, specs)[0]
    assert ok["ok"]
    f = M.compare(base, {"ttft": 0.61}, specs)[0]
    assert not f["ok"] and f["bound"] == pytest.approx(0.6)
    return [ok, f]


def _bare_number(M):
    specs = [M.MetricSpec("v", "higher_better", rel_tol=0.0)]
    ok = M.compare({"v": 5.0}, {"v": 5.0}, specs)[0]
    bad = M.compare({"v": 5.0}, {"v": 4.9}, specs)[0]
    assert ok["ok"] and not bad["ok"]
    return [ok, bad]


def _absent_from_baseline(M):
    out = M.compare({}, {"new_metric": 1.0}, [M.MetricSpec("new_metric",
                                                           "exact")])
    assert out == []
    return out


def _missing_from_observed(M):
    f = M.compare({"v": 1.0}, {}, [M.MetricSpec("v", "exact")])[0]
    assert not f["ok"] and f["observed"] is None
    assert "missing" in f["detail"]
    text = M.format_findings([f])
    assert "MISSING" in text
    return [f, text]


def _assert_no_regression(M):
    specs = [M.MetricSpec("single_stream.sparse.tok_s", "higher_better",
                          rel_tol=2.0),
             M.MetricSpec("pad_frac", "exact")]
    base = {"single_stream.sparse.tok_s": {"value": 100.0, "lo": 90.0,
                                           "hi": 110.0},
            "pad_frac": 0.125}
    ok = M.assert_no_regression(base, {"single_stream.sparse.tok_s": 95.0,
                                       "pad_frac": 0.125}, specs,
                                label="serve")
    assert len(ok) == 2 and all(f["ok"] for f in ok)
    with pytest.raises(M.PerfRegressionError) as ei:
        M.assert_no_regression(base, {"single_stream.sparse.tok_s": 9.0,
                                      "pad_frac": 0.125}, specs,
                               label="serve")
    msg = str(ei.value)
    assert "single_stream.sparse.tok_s" in msg
    assert "[90, 110]" in msg and "9" in msg
    assert "pad_frac" not in msg.split("out of band")[1]
    assert ei.value.findings and len(ei.value.findings) == 2
    return [ok, msg, ei.value.findings]


CASES = {"spec_validation": _spec_validation, "exact": _exact,
         "higher_better_uses_window_lo": _higher_better,
         "lower_better_uses_window_hi": _lower_better,
         "bare_number_baseline": _bare_number,
         "spec_absent_from_baseline": _absent_from_baseline,
         "metric_missing_from_observed": _missing_from_observed,
         "assert_no_regression_names_the_offender": _assert_no_regression}


@pytest.mark.parametrize("case", list(CASES))
def test_findings_equal_the_reference(case):
    assert CASES[case](PREG) == CASES[case](RREG)
