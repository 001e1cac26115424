"""The program's spans laid over the device trace (``harness/spans.py``) on
made-up device ops and spans, and ``trace_spans.py`` run end to end on a
tiny cell on the CPU (no device trace there)."""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from perfbench.harness import devtrace
from perfbench.harness import spans as S
from perfbench.harness.devtrace import DeviceOp, TickOps
from perfbench.harness.manifest import ROOT
from perfbench.run import forbidden_modules
from perfbench.tests._tiny import TickClock, tiny_cell

US = 1_000


@dataclasses.dataclass
class Sp:
    name: str
    t0_ns: int
    t1_ns: int
    sid: int = 0
    parent_id: int = 0
    tid: int = 0


def _op(name, a, b):
    return DeviceOp(name, a * US, b * US)


def _tick(index, *ops):
    return TickOps(index, list(ops))


# ---------------------------------------------------------------- splitting
def test_idle_interval_split_over_nested_spans_and_the_harness():
    """Idle 100-200 us inside a decode tick: 100-120 the harness, 120-150
    ``decode.launch`` alone, 150-170 its child ``attn.core``, 170-180 the
    launch again, 180-200 the harness."""
    ticks = [_tick(0, _op("k0", 0, 100), _op("k1", 200, 210))]
    spans = [Sp("decode.launch", 120 * US, 180 * US, 1),
             Sp("attn.core", 150 * US, 170 * US, 2, 1)]
    got = S.idle_by_span(ticks, ["decode"], spans)
    want = {"decode: (harness)": 40e-6, "decode: decode.launch": 40e-6,
            "decode: attn.core": 20e-6}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=0, abs=1e-15)


def test_the_gap_before_a_ticks_first_op_is_between():
    ticks = [_tick(0, _op("k0", 0, 10)), _tick(1, _op("k1", 30, 40),
                                               _op("k2", 45, 50))]
    spans = [Sp("scheduler.admit", 12 * US, 22 * US),
             Sp("host.sync", 41 * US, 44 * US)]
    got = S.idle_by_span(ticks, ["decode", "prefill"], spans)
    assert got == pytest.approx({"between: (harness)": 10e-6,
                                 "between: scheduler.admit": 10e-6,
                                 "prefill: (harness)": 2e-6,
                                 "prefill: host.sync": 3e-6})


def test_the_parts_sum_to_the_idle_time_of_the_old_split():
    """Spans that cross several idle stretches, overlapping ops, a span
    reaching past the last op: every idle nanosecond lands in one part,
    and the parts sum to ``devtrace.idle_gaps``' totals by tick kind."""
    ops0 = [_op("a", 0, 50), _op("b", 20, 60), _op("c", 90, 95)]
    ops1 = [_op("d", 130, 140), _op("e", 170, 171), _op("f", 400, 420)]
    ticks = [_tick(0, *ops0), _tick(1, *ops1)]
    kinds = ["decode", "prefill"]
    spans = [Sp("engine.step", 55 * US, 500 * US, 1),
             Sp("decode.launch", 58 * US, 180 * US, 2, 1),
             Sp("mlp", 70 * US, 135 * US, 3, 2),
             Sp("host.sync", 300 * US, 380 * US, 4, 1)]
    got = S.idle_by_span(ticks, kinds, spans)
    old = devtrace.idle_gaps(ticks, kinds)
    by_kind: dict = {}
    for key, sec in got.items():
        kind = key.split(": ")[0]
        by_kind[kind] = by_kind.get(kind, 0.0) + sec
    assert by_kind["between"] == pytest.approx(old["between ticks"])
    assert by_kind["decode"] == pytest.approx(old["inside decode ticks"])
    assert by_kind["prefill"] == pytest.approx(old["inside prefill ticks"])
    assert got["decode: decode.launch"] == pytest.approx(10e-6)  # 60-70
    assert got["decode: mlp"] == pytest.approx(20e-6)            # 70-90
    assert got["between: mlp"] == pytest.approx(35e-6)           # 95-130
    assert got["prefill: decode.launch"] == pytest.approx(39e-6)
    assert got["prefill: host.sync"] == pytest.approx(80e-6)
    # 180-300 and 380-400
    assert got["prefill: engine.step"] == pytest.approx((120 + 20) * 1e-6)


def test_innermost_leaves_out_what_no_span_covers():
    spans = [Sp("a", 0, 100), Sp("b", 10, 20), Sp("c", 20, 30),
             Sp("d", 150, 160)]
    assert S.innermost(spans) == [(0, 10, "a"), (10, 20, "b"),
                                  (20, 30, "c"), (30, 100, "a"),
                                  (150, 160, "d")]


# ------------------------------------------------------------------ readers
def _run_spans():
    """Two decode ticks and a prefill tick, as the engine nests them."""
    out, sid = [], iter(range(1, 100))
    for t, kind in ((0, "decode"), (1000, "prefill"), (2000, "decode")):
        step = Sp("engine.step", t * US, (t + 900) * US, next(sid))
        out.append(step)
        if kind == "decode":
            dstep = Sp("decode.step", (t + 10) * US, (t + 800) * US,
                       next(sid), step.sid)
            out += [dstep,
                    Sp("decode.launch", (t + 20) * US, (t + 520) * US,
                       next(sid), dstep.sid),
                    Sp("host.sync", (t + 600) * US, (t + 700) * US,
                       next(sid), dstep.sid)]
        else:
            out.append(Sp("prefill.launch", (t + 20) * US, (t + 420) * US,
                          next(sid), step.sid))
    return out


def test_the_readers_read_means_and_shares():
    spans = _run_spans()
    assert S.launch_ms(spans) == pytest.approx(0.5)
    assert S.readback_ms(spans) == pytest.approx(0.1)
    ticks = [_tick(0, _op("k", 30, 40), _op("Memcpy DtoH (Device -> "
                                            "Pageable)", 690, 695)),
             _tick(1, _op("k", 1010, 1020), _op("k", 1500, 1510)),
             _tick(2, _op("k", 2030, 2040),
                   _op("Memcpy DtoH (Device -> Pageable)", 2900, 2910))]
    kinds = ["decode", "prefill", "decode"]
    # idle: 40-690 (decode, launch 40-520 = 480 of 650), 695-1010 (none
    # launching), 1020-1500 (prefill, launch 1020-1420 = 400), 1510-2030
    # (launch 2020-2030 = 10), 2040-2900 (launch 2040-2520 = 480)
    idle = 650 + 315 + 480 + 520 + 860
    assert S.idle_launching_share(ticks, kinds, spans) == pytest.approx(
        100.0 * (480 + 400 + 10 + 480) / idle)
    check = S.clock_check(ticks, kinds, spans)
    assert check["ticks"] == 2 and check["inside"] == 1
    assert check["share"] == 0.5
    assert check["worst_us"] == pytest.approx(210.0)


def test_the_readers_give_none_without_spans():
    ticks = [_tick(0, _op("k", 0, 10), _op("k", 20, 30))]
    assert S.launch_ms([]) is None
    assert S.readback_ms([]) is None
    assert S.idle_launching_share(ticks, ["decode"], []) is None
    assert S.pack_seconds([]) is None
    assert S.clock_check(ticks, ["decode"], []) is None
    assert S.idle_by_span(ticks, ["decode"], []) == {
        "decode: (harness)": pytest.approx(10e-6)}


def test_pack_seconds_only_where_a_pack_build_span_is():
    spans = _run_spans()
    assert S.pack_seconds(spans) is None
    spans.append(Sp("pack.build", 0, 2_500_000_000, 99))
    spans.append(Sp("pack.group", 0, 1_000_000_000, 100, 99))
    assert S.pack_seconds(spans) == pytest.approx(2.5)


def test_spans_move_onto_the_device_clock_between_markers():
    """Markers at host 0, 1000, 2000 us start on the device at 5, 1105
    (the device's clock ran 10% fast between the first two) and 2105: a
    span is moved linearly between the markers around it, and by the
    nearest marker's offset outside them."""
    host, dev = [0, 1000 * US, 2000 * US], [5 * US, 1105 * US, 2105 * US]
    spans = [Sp("a", 500 * US, 1500 * US, 1, 0, 7), Sp("b", -10 * US, 0, 2),
             Sp("c", 2500 * US, 2600 * US, 3)]
    a, b, c = S.on_device_clock(spans, host, dev)
    assert (a.t0_ns, a.t1_ns) == (555 * US, 1605 * US)
    assert (a.name, a.sid, a.parent_id, a.tid) == ("a", 1, 0, 7)
    assert (b.t0_ns, b.t1_ns) == (-5 * US, 5 * US)
    assert (c.t0_ns, c.t1_ns) == (2605 * US, 2705 * US)
    with pytest.raises(ValueError):
        S.on_device_clock(spans, host, dev[:2])


def test_moving_repairs_a_device_clock_that_steps():
    """Two decode ticks whose device ops carry a clock 3 ms ahead from the
    second tick on: as stamped, the second tick's copy ends outside its
    ``host.sync``; moved by the markers (a step, over ``STEP_NS``: the
    first tick keeps its own offset), both end inside."""
    spans, ticks, host, dev = [], [], [], []
    for k, step in enumerate((0, 3000)):
        t = step * US
        sid = 10 * k + 1
        spans += [Sp("engine.step", t, t + 900 * US, sid),
                  Sp("decode.step", t + 10 * US, t + 800 * US, sid + 1, sid),
                  Sp("host.sync", t + 600 * US, t + 700 * US, sid + 2,
                     sid + 1)]
        skew = 3000 * US * k
        host.append(t - 5 * US)
        dev.append(t + skew)
        ticks.append(_tick(k, _op("k", step + 20 + 3000 * k,
                                  step + 40 + 3000 * k),
                           _op("Memcpy DtoH (Device -> Pageable)",
                               step + 640 + 3000 * k,
                               step + 650 + 3000 * k)))
    kinds = ["decode", "decode"]
    assert S.clock_check(ticks, kinds, spans)["share"] == 0.5
    moved = S.on_device_clock(spans, host, dev)
    check = S.clock_check(ticks, kinds, moved)
    assert check["share"] == 1.0 and check["lead_us"] <= 0


def test_in_window_keeps_spans_wholly_inside():
    spans = [Sp("a", 0, 10), Sp("b", 10, 20), Sp("c", 15, 30)]
    assert [s.name for s in S.in_window(spans, 5, 25)] == ["b"]


# -------------------------------------------------------------- the tool
def test_on_in_window_alternates_in_pairs():
    from perfbench.trace_spans import on_in_window
    assert [on_in_window(w) for w in range(8)] == [
        True, False, False, True, True, False, False, True]


@pytest.mark.parametrize("name", ["tiny-espim-int8", "tiny-dense-bf16"])
def test_trace_spans_runs_a_tiny_cell(name):
    from perfbench.trace_spans import trace_cell
    r = trace_cell(tiny_cell(name), 2**31 + 11, 1.0, 4, device="cpu",
                   clock=TickClock(0.01), log=lambda m: None)
    assert [w["tracer"] for w in r["windows"]] == [True, False, False, True]
    assert (r["pack_s"] is None) == (name == "tiny-dense-bf16")
    if r["pack_s"] is not None:
        assert set(r["pack_phases"]) >= {"pack.build", "pack.prune",
                                         "pack.group", "pack.quantize",
                                         "pack.upload"}
    for w in r["windows"]:
        assert w["decode_ticks"] > 0
        if not w["tracer"]:
            assert "coverage" not in w
            continue
        cov = w["coverage"]["decode.launch"]
        assert cov["parents"] == w["decode_ticks"]
        assert cov["coverage"] >= 0.9 and cov["overlap_errors"] == 0
        assert w["decode_launch_host_ms"] > 0
        assert w["decode_readback_ms"] > 0
        assert 0 <= w["cache_view_rebuilds_per_decode_tick"] <= 1
        assert w["idle_by_span"] is None and w["clock_check"] is None
    json.dumps(r)


def test_the_tool_loads_no_jax():
    code = ("import json, sys\n"
            "import perfbench.trace_spans, perfbench.harness.spans\n"
            "import repro_torch.telemetry.trace\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "perfbench.harness.spans" in mods
    assert forbidden_modules(mods) == []
