"""Lay the program's own spans over the device trace of one cell's traced
windows, with the program's tracer on and off in turns, in one process.

    python3 perfbench/trace_spans.py --workload <name> --seed <n> \\
        --seconds <s> [--windows 4] [--out <file.json>]

Set-up is the benchmark's (``harness/cell.run_cell``) with a live
``Tracer`` installed before the weights are made, so the pack's phases
are spans.  Then ``--windows`` windows of ``--seconds`` each run as the
benchmark's traced run does (one device profile over all of them, a
marker kernel before every tick, a synchronise after it), the program's
tracer on in windows 0, 3, 4, 7, ... and off in the others (on, off,
off, on).  The host's clock is read as each marker is launched, which
moves the spans onto the device trace's clock (``harness/spans.py``).

It prints one JSON object as its last line of standard output: the
pack's seconds by phase, the host cost of one span, and for each window
the decode tick's mean milliseconds and, with the tracer on, what
``harness/spans.py`` reads (idle device seconds by span, the clock check
with the spans moved and as stamped, the forward's coverage of
``decode.launch``, the host's launch and readback milliseconds, the
share of idle time spent launching, the cache view's rebuilds a decode
tick); every window's whole idle split goes to standard error.  With
``--device cpu`` (a rehearsal) there is no device trace and the readings
that need one are null.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import threading
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

from perfbench.run import setup_paths  # noqa: E402

__all__ = ["trace_cell", "window_record", "on_in_window"]

REBUILDS = "serve_cache_view_rebuilds_total"


def on_in_window(w: int) -> bool:
    """The tracer's state in window ``w``: on, off, off, on, on, off, ..."""
    return w % 4 in (0, 3)


def _phases(spans: list) -> dict:
    """Seconds of the set-up's pack spans by name."""
    out: dict = {}
    for s in spans:
        if s.name.startswith("pack."):
            out[s.name] = out.get(s.name, 0.0) + (s.t1_ns - s.t0_ns) / 1e9
    return out


def window_record(spans: list, ticks: list, kinds: list, rebuilds: int,
                  t_open_ns: int, t_close_ns: int, tick_ops=None,
                  marks=None) -> dict:
    """What one window with the tracer on shows.  ``ticks`` are the
    loop's ``Tick``s of the window, ``kinds`` the kinds of every tick the
    device trace's ``TickOps`` index, ``rebuilds`` the view-rebuild
    counter's rise over the window; ``tick_ops`` (the window's ``TickOps``)
    and ``marks`` (the host's and the device's clock at each of its tick
    markers) are None without a device trace."""
    from repro_torch.telemetry.trace import span_coverage

    from perfbench.harness import spans as S
    me = threading.get_ident()
    win = [s for s in S.in_window(spans, t_open_ns, t_close_ns)
           if s.tid == me]
    n_decode = sum(t.kind == "decode" for t in ticks)
    rec = {"decode_launch_host_ms": S.launch_ms(win),
           "decode_readback_ms": S.readback_ms(win),
           "cache_view_rebuilds_per_decode_tick": (
               rebuilds / n_decode if n_decode else None),
           "coverage": {p: span_coverage(win, p) for p in S.LAUNCH_SPANS},
           "device_idle_launching_share": None, "clock_check": None,
           "clock_check_unmoved": None, "idle_by_span": None,
           "idle_s": None}
    for cov in rec["coverage"].values():
        cov["overlap_errors"] = len(cov["overlap_errors"])
    if tick_ops is not None:
        moved = S.on_device_clock(win, *marks)
        idle = S.idle_intervals(tick_ops, kinds)
        rec["idle_s"] = sum(b - a for a, b, _ in idle) / 1e9
        rec["idle_by_span"] = S.idle_by_span(tick_ops, kinds, moved)
        rec["device_idle_launching_share"] = S.idle_launching_share(
            tick_ops, kinds, moved)
        rec["clock_check"] = S.clock_check(tick_ops, kinds, moved)
        rec["clock_check_unmoved"] = S.clock_check(tick_ops, kinds, win)
    return rec


def trace_cell(cell, seed: int, seconds: float, windows: int, *,
               device: str = "cuda", clock=None, log=print) -> dict:
    """Set the cell up with the program's tracer live, then run
    ``windows`` traced windows -> the record ``main`` prints."""
    import torch
    from repro_torch.telemetry.trace import CLOCK, Tracer, set_tracer

    from perfbench.harness import devtrace
    from perfbench.harness.cell import _import_program, program_config
    from perfbench.traffic.generator import RequestStream

    get_config, sparsify_model, ServeEngine, Request = _import_program()
    config, mix, fam = cell.config, cell.mix, cell.family
    serving = config["serving"]
    dims = fam.Dims(config["model"])
    cfg = program_config(get_config, config, None, fam)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    tracer = Tracer()
    prev = set_tracer(tracer)
    try:
        weights = fam.make_weights(dims, cfg.padded_vocab, seed, dev,
                                   cfg.dtype)
        params = fam.param_tree(weights)
        sparse = None
        if serving.get("sparse"):
            sparse = sparsify_model(cfg, params, float(serving["sparsity"]),
                                    projections=serving["projections"],
                                    chunk_cols=int(serving["chunk_cols"]),
                                    quant=cfg.espim_quant, device=dev)
        eng_kw = dict(mix["engine"])
        eng = ServeEngine(cfg, params, eng_kw.pop("batch_slots"),
                          eng_kw.pop("max_len"), temperature=0.0,
                          sparse=sparse, device=dev, **eng_kw)
        pack = _phases(tracer.spans())
        log(f"[setup] pack phases {pack}")
        stream = RequestStream(mix, seed, dims.vocab, cell.bench_dir)
        loop = cell.loop(
            eng, lambda k, p, n: Request(rid=k, prompt=p, max_new_tokens=n),
            stream, mix, seed, **({"clock": clock} if clock else {}))
        loop.start()
        loop.run_ticks(int(mix["ramp_ticks"]))
        prof, marks, tick_kw = None, [], {}
        if on_card:
            prof = devtrace.Profiler(torch)
            prof.learn_marker()

            def before():
                marks.append(CLOCK())
                prof.mark()
            tick_kw = {"before": before, "after": torch.cuda.synchronize}
        rebuilds = eng.metrics.counter(REBUILDS)
        gc.collect()
        gc.freeze()
        # one device profile over every window, as the benchmark's traced
        # run takes one: a profile started again can lose its first marker
        if prof is not None:
            prof.start()
        first_tick = len(loop.ticks)
        runs = []
        for w in range(windows):
            tracer.enabled = on_in_window(w)
            tracer.clear()
            r0 = rebuilds.value
            t_open_ns = CLOCK()
            _, _, first = loop.run_for(seconds, **tick_kw)
            runs.append((tracer.enabled, first, len(loop.ticks), t_open_ns,
                         CLOCK(), rebuilds.value - r0,
                         tracer.spans() if tracer.enabled else None))
        ops = prof.stop() if prof is not None else None
        span_us = span_cost_us()
        gc.unfreeze()
    finally:
        set_tracer(prev)
    tick_ops, device_marks = None, None
    if ops is not None:
        tick_ops, _ = devtrace.split_ticks(ops, prof.marker_name)
        device_marks = [op.start_ns for op in ops
                        if op.name == prof.marker_name]
        if len(tick_ops) != len(loop.ticks) - first_tick:
            log(f"[trace] {len(tick_ops)} tick markers for "
                f"{len(loop.ticks) - first_tick} ticks: no device readings")
            tick_ops = None
    kinds = [t.kind for t in loop.ticks[first_tick:]]
    out = []
    for w, (on, a, b, t_open_ns, t_close_ns, rises, spans) in \
            enumerate(runs):
        ticks = loop.ticks[a:b]
        dec = [t.t1 - t.t0 for t in ticks if t.kind == "decode"]
        rec = {"tracer": on, "ticks": len(ticks), "decode_ticks": len(dec),
               "decode_tick_ms": (1e3 * sum(dec) / len(dec)
                                  if dec else None)}
        if on:
            i, j = a - first_tick, b - first_tick
            rec.update(window_record(
                spans, ticks, kinds, rises, t_open_ns, t_close_ns,
                None if tick_ops is None else tick_ops[i:j],
                None if tick_ops is None else (marks[i:j],
                                               device_marks[i:j])))
            for name, sec in sorted((rec["idle_by_span"] or {}).items(),
                                    key=lambda kv: -kv[1]):
                log(f"[window {w}] idle {sec:.6f} s  {name}")
        brief = {k: (v if not isinstance(v, dict) or "offsets_us" not in v
                     else {x: y for x, y in v.items() if x != "offsets_us"})
                 for k, v in rec.items() if k != "idle_by_span"}
        log(f"[window {w}] {json.dumps(brief)}")
        out.append(rec)
    on = [r["decode_tick_ms"] for r in out if r["tracer"]]
    off = [r["decode_tick_ms"] for r in out if not r["tracer"]]
    ratio = (sum(on) / len(on)) / (sum(off) / len(off)) if on and off \
        and None not in on + off else None
    card = torch.cuda.get_device_name(dev) if on_card else "cpu"
    return {"workload": cell.name, "seed": seed, "device": card,
            "seconds": seconds, "pack_s": pack.get("pack.build"),
            "pack_phases": pack, "windows": out,
            "decode_tick_on_over_off": ratio, "span_us": span_us}


def span_cost_us(n: int = 100_000) -> dict:
    """Host microseconds of one empty span, tracer off and on."""
    import time

    from repro_torch.telemetry.trace import Tracer
    out = {}
    for on in (False, True):
        tr = Tracer(enabled=on)
        t0 = time.perf_counter()
        for _ in range(n):
            with tr.span("s", cat="c"):
                pass
        out["on" if on else "off"] = (time.perf_counter() - t0) / n * 1e6
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--windows", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    setup_paths()
    from perfbench.harness.manifest import Cell
    result = trace_cell(Cell(args.workload), args.seed, args.seconds,
                        args.windows, device=args.device,
                        log=lambda m: print(m, file=sys.stderr, flush=True))
    line = json.dumps(result)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
