"""The device trace of the traced run: ``torch.profiler`` over the window,
device activity only, and one marker kernel before every tick.

The markers cut the device's timeline into ticks without aligning
clocks: the work of a tick is launched after its marker and before the
next on the one stream the engine uses, so in device order every kernel
between two markers belongs to the first's tick.  The marker is
``torch.cuda._sleep`` for a few cycles; its kernel name is learnt once in
set-up from a profile of the marker alone (which also starts the
profiler's device tracing before the window).
"""
from __future__ import annotations

import dataclasses

__all__ = ["MARK_CYCLES", "DeviceOp", "TickOps", "Profiler",
           "split_ticks", "busy_seconds", "idle_gaps"]

MARK_CYCLES = 64
_COPIES = ("Memcpy", "Memset")


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int

    @property
    def kernel(self) -> bool:
        return not self.name.startswith(_COPIES)


@dataclasses.dataclass
class TickOps:
    index: int                # tick of the window
    ops: list


def _device_ops(prof) -> list:
    """Every device op of a finished profile as ``DeviceOp``s, read from
    the profiler's raw results (no event tree is built)."""
    from torch.autograd import DeviceType
    return [DeviceOp(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


class Profiler:
    """Device activity of the window.  ``learn_marker()`` in set-up, then
    ``start()`` before the window, ``mark()`` before each tick, and
    ``stop()`` after it -> the device ops in device order."""

    def __init__(self, torch):
        self.torch = torch
        self.marker_name = None
        self._prof = None

    def mark(self) -> None:
        self.torch.cuda._sleep(MARK_CYCLES)

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CUDA])

    def learn_marker(self) -> str:
        torch = self.torch
        torch.cuda.synchronize()
        prof = self._profile()
        with prof:
            self.mark()
            torch.cuda.synchronize()
        names = {op.name for op in _device_ops(prof)}
        if len(names) != 1:
            raise RuntimeError(f"the marker's profile shows {sorted(names)}, "
                               "not one kernel")
        self.marker_name = names.pop()
        return self.marker_name

    def start(self) -> None:
        self.torch.cuda.synchronize()
        self._prof = self._profile()
        self._prof.__enter__()

    def stop(self) -> list:
        self.torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        ops = _device_ops(self._prof)
        self._prof = None
        return sorted(ops, key=lambda o: (o.start_ns, o.end_ns))


def split_ticks(ops: list, marker: str) -> tuple:
    """Device ops in device order -> ([TickOps] one a marker, in order;
    the ops without their markers)."""
    ticks, work = [], []
    for op in ops:
        if op.name == marker:
            ticks.append(TickOps(len(ticks), []))
            continue
        work.append(op)
        if ticks:
            ticks[-1].ops.append(op)
    return ticks, work


def busy_seconds(ops: list) -> float:
    """Seconds in which at least one op ran: the union of their spans."""
    busy, reach = 0, None
    for op in sorted(ops, key=lambda o: o.start_ns):
        if reach is None or op.start_ns >= reach:
            busy += op.end_ns - op.start_ns
            reach = op.end_ns
        elif op.end_ns > reach:
            busy += op.end_ns - reach
            reach = op.end_ns
    return busy / 1e9


def idle_gaps(ticks: list, kinds: list) -> dict:
    """Idle device seconds by what the host was doing: inside a tick of
    each kind (the host launching, or reading back, the tick's work),
    and between ticks (engine bookkeeping, the harness, the next tick's
    scheduling before its first launch)."""
    out: dict = {}
    reach = None
    for t in ticks:
        kind = kinds[t.index] if t.index < len(kinds) else "unknown"
        first = True
        for op in sorted(t.ops, key=lambda o: o.start_ns):
            if reach is not None and op.start_ns > reach:
                key = ("between ticks" if first
                       else f"inside {kind} ticks")
                out[key] = out.get(key, 0.0) + (op.start_ns - reach) / 1e9
            reach = op.end_ns if reach is None else max(reach, op.end_ns)
            first = False
    return out
