"""One run of one cell: set-up, the window, the check, the metrics.

Set-up (timed as ``setup_s``, from the start of the process): weights made
on the device from the seed, the program's offline pack (ESPIM cells),
the engine (which verifies the packs), then the loop's ramp, which warms
every shape the window uses (the prefill chunk and the full decode
batch).  Set-up ends with a collection, after which the garbage
collector leaves every object set-up made alone (``gc.freeze``): the
window's collections walk only what the window makes.  The window runs
the loop for ``seconds``.  After it, the peak memory is read, the
program's state freed, and the reference judges a sample of the requests
the window finished.

The cell's configuration names its family and value code, its mix the
loop and the length distributions: each a module found by name
(``manifest.Cell``).
"""
from __future__ import annotations

import dataclasses
import gc
import time

import torch

from perfbench.harness import check, devtrace, provenance
from perfbench.harness.manifest import load_reader
from perfbench.harness.peaks import peaks_of
from perfbench.metrics._work import WorkModel, index_bytes
from perfbench.traffic.generator import RequestStream

__all__ = ["Run", "run_cell", "program_config", "TOP_OPS"]

TOP_OPS = 10


@dataclasses.dataclass
class Run:
    """What a metric's reader sees of one run."""
    setup_s: float
    t_open: float
    t_close: float
    ticks: list               # the window's ticks
    finished: list            # every request finished in the run
    inflight: list            # the requests still in flight at the close
    refused: list             # the requests the engine would not take
    work: WorkModel
    peaks: dict | None
    trace: dict | None = None

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def in_window(self, t) -> bool:
        return t is not None and self.t_open <= t <= self.t_close


def program_config(get_config, config: dict, quant: str | None, family):
    """The program's ModelConfig of a configuration file, held to every
    size the file states (``family.PROGRAM_FIELDS``), and the file held
    to what the program cannot change (``family.program_implied``)."""
    model, serving = config["model"], config["serving"]
    sparse = bool(serving.get("sparse"))
    cfg = get_config(config["program_arch"],
                     reduced=bool(config.get("program_reduced"))).replace(
        **config.get("program_overrides", {}),
        n_layers=int(model["num_hidden_layers"]),
        espim_sparsity=float(serving["sparsity"]) if sparse else 0.0,
        espim_quant=(quant or serving["quant"]) if sparse else "none")
    if cfg.param_dtype != model["torch_dtype"]:
        raise ValueError(f"the program keeps weights in {cfg.param_dtype}, "
                         f"the configuration states {model['torch_dtype']}")
    for key, field in family.PROGRAM_FIELDS.items():
        have = getattr(cfg, field)
        if have != model[key]:
            raise ValueError(f"{config['name']}: the program's {field} is "
                             f"{have!r}, the configuration's {key} "
                             f"{model[key]!r}")
    for key, have in family.program_implied(family.Dims(model)).items():
        if key in model and model[key] != have:
            raise ValueError(f"{config['name']}: the program runs {key} "
                             f"{have!r}, the configuration states "
                             f"{model[key]!r}")
    return cfg


def _import_program():
    from repro_torch.configs.registry import get_config
    from repro_torch.core.sparse_model import sparsify_model
    from repro_torch.serve.engine import Request, ServeEngine
    return get_config, sparsify_model, ServeEngine, Request


def _work_model(cell, dims, nnz: dict | None):
    """The work counts of the cell: the family's own ``work_model(dims,
    nnz, codes)`` where it has one, else ``_work.WorkModel`` over the
    family's groups (a decoder layer with a K/V cache)."""
    codes = None
    if cell.codes is not None:
        codes = {"value": cell.codes.VALUE_BYTES,
                 "index": index_bytes(int(
                     cell.config["serving"]["chunk_cols"])),
                 "scale": cell.codes.SCALE_BYTES,
                 "scale_rows": cell.codes.GROUP_ROWS}
    own = getattr(cell.family, "work_model", None)
    if own is not None:
        return own(dims, nnz, codes)
    return WorkModel(dims.layers, dims.d, dims.heads, dims.kv_heads,
                     dims.hd, dims.vocab, cell.family.group_shapes(dims),
                     nnz or cell.family.dense_weights(dims), codes)


def _trace_record(ops: list, marker: str, ticks: list, window_s: float
                  ) -> dict:
    tick_ops, work = devtrace.split_ticks(ops, marker)
    if len(tick_ops) != len(ticks):
        raise RuntimeError(f"the trace holds {len(tick_ops)} tick markers "
                           f"for {len(ticks)} ticks of the window")
    kinds = [t.kind for t in ticks]
    busy = devtrace.busy_seconds(work)
    by_name: dict = {}
    for op in work:
        by_name[op.name] = by_name.get(op.name, 0.0) + (
            op.end_ns - op.start_ns) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_OPS]
    gaps = sorted(devtrace.idle_gaps(tick_ops, kinds).items(),
                  key=lambda kv: -kv[1])[:TOP_OPS]
    return {"ticks": tick_ops, "kinds": kinds, "busy_s": busy,
            "window_s": window_s,
            "device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}


def run_cell(cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             control: bool = False, fault=None, clock=None,
             log=print) -> dict:
    """Run ``cell`` (a ``manifest.Cell``) once -> the result dict.
    ``control`` runs the cell's control in the program's place (for the
    calibration and the tests only); ``fault(engine)`` plants a fault and
    ``clock`` replaces the loop's clock (for the tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    get_config, sparsify_model, ServeEngine, Request = _import_program()
    config, mix, fam = cell.config, cell.mix, cell.family
    serving = config["serving"]
    ctl = cell.limits["control"] if control else {}
    dims = fam.Dims(config["model"])
    cfg = program_config(get_config, config, ctl.get("program_quant"), fam)
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    if on_card:
        log(f"[setup] {provenance.host_probe(torch, dev)}")
    weights = fam.make_weights(dims, cfg.padded_vocab, seed, dev, cfg.dtype)
    params = fam.param_tree(weights)
    sparse = None
    if serving.get("sparse"):
        t0 = time.perf_counter()
        sparse = sparsify_model(cfg, params, float(serving["sparsity"]),
                                projections=serving["projections"],
                                chunk_cols=int(serving["chunk_cols"]),
                                quant=cfg.espim_quant, device=dev)
        log(f"[setup] pack {time.perf_counter() - t0:.3f} s")
    eng_kw = dict(mix["engine"])
    eng = ServeEngine(cfg, params, eng_kw.pop("batch_slots"),
                      eng_kw.pop("max_len"), temperature=0.0, sparse=sparse,
                      device=dev, **eng_kw)
    if fault is not None:
        fault(eng)
    stream = RequestStream(mix, seed, dims.vocab, cell.bench_dir)
    loop = cell.loop(
        eng, lambda k, p, n: Request(rid=k, prompt=p, max_new_tokens=n),
        stream, mix, seed, **({"clock": clock} if clock else {}))
    loop.start()
    loop.run_ticks(int(mix["ramp_ticks"]))
    prof = None
    tick_kw = {}
    if trace:
        prof = devtrace.Profiler(torch)
        prof.learn_marker()
        prof.start()
        tick_kw = {"before": prof.mark, "after": torch.cuda.synchronize}
    if on_card:
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    t_open, t_close, first = loop.run_for(seconds, **tick_kw)
    ops = prof.stop() if prof is not None else None
    gc.unfreeze()
    if on_card:
        log(f"[window] {provenance.host_probe(torch, dev)}")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    window_ticks = loop.ticks[first:]
    done = [r for r in loop.finished if t_open <= r.t_done <= t_close]
    # a request cut short, or served by the dense fallback after a
    # quarantine, is a failure
    failed = (sum(1 for r in done if not r.ok)
              + eng.stats.requests_degraded)
    picked = check.sample([r for r in done if r.ok], seed,
                          int(cell.limits["sample_requests"]))
    log(f"[window] {seconds} s: {len(window_ticks)} ticks, {len(done)} "
        f"requests finished, {failed} failed; {len(picked)} checked")
    dec = sorted(t.t1 - t.t0 for t in window_ticks if t.kind == "decode")
    if dec:
        q = [1e3 * dec[int(f * (len(dec) - 1))] for f in (0.1, 0.5, 0.9)]
        log(f"[window] decode tick ms p10 {q[0]:.3f} p50 {q[1]:.3f} "
            f"p90 {q[2]:.3f}")

    # the program's state goes before the reference runs
    inflight = list(loop.inflight.values())
    loop.eng = None
    loop.inflight.clear()
    del eng, sparse, params, weights
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = check.ReferenceModel(cell, dims, cfg.padded_vocab, seed, dev)
    code = ctl.get("reference_code")
    readings = check.gap_readings(
        ref, picked, fam.control_weights(ref.w, code) if code else None)
    work = _work_model(cell, dims, ref.nnz)
    del ref
    log(f"[check] reference {time.perf_counter() - t0:.3f} s over "
        f"{readings['tokens']} served tokens")

    card = torch.cuda.get_device_name(dev) if on_card else "cpu"
    run = Run(setup_s, t_open, t_close, window_ticks, loop.finished,
              inflight, loop.refused, work,
              peaks_of(card) if on_card else None)
    dev_rec = {"platform": "gpu" if on_card else "cpu", "kind": card,
               "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if ops is not None:
        run.trace = _trace_record(ops, prof.marker_name, window_ticks,
                                  run.window_s)
        dev_rec["busy_s"] = run.trace["busy_s"]
        dev_rec["window_s"] = run.trace["window_s"]
        breakdown = {"device_ops": run.trace["device_ops"],
                     "idle_gaps": run.trace["idle_gaps"]}
    metrics = {}
    for m in cell.metrics(trace):
        value = load_reader(m["name"], cell.bench_dir)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    limit = cell.limits["max_logit_gap"]
    # the control's best tokens stand in for the served ones
    widest = (readings["control"] if code else readings)["widest"]
    checks = {"logit_gap": {"value": widest, "limit": limit},
              "failed": {"value": failed, "limit": 0}}
    correct = (widest is not None and limit is not None and widest <= limit
               and failed == 0)
    result = {"correct": bool(correct), "attempted": len(done),
              "failed": failed, "metrics": metrics, "device": dev_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["readings"] = readings
    result["check"] = checks
    return result
