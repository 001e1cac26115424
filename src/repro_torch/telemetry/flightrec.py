"""Always-on flight recorder for the serving stack (DESIGN.md §14).

The span tracer (``telemetry/trace.py``) is opt-in: it fences device
work for exact attribution, so production engines run with it disabled
and a fault caught in the wild used to mean "re-run with ``--trace`` and
hope it reproduces".  The flight recorder closes that gap: a bounded
ring buffer of recent request/fault/step events that every engine feeds
*unconditionally* — no fencing, no clock discipline beyond one
``perf_counter_ns`` read, O(capacity) memory forever — which the fault
ladder dumps to ``FLIGHT_<reason>.json`` the moment something trips
(nonfinite quarantine, retry exhaustion, shed/preempt storm, crash
drill).  A post-mortem therefore always has the last ~thousand events
leading up to the incident, with the same ``rid``-keyed event names the
tracer emits, plus a full metrics snapshot at dump time.

Cost contract (pinned in ``tests/test_flightrec.py``):

* ``enabled=False`` → ``record()`` is a constant-time early return that
  allocates nothing.
* enabled → one tuple per event into a preallocated ring; memory is
  O(capacity) no matter how long the engine runs (the ring overwrites,
  it never grows).
* files are written ONLY by ``trip()``/``dump()``, and ``trip()`` is a
  no-op unless ``autodump`` is set — library code and tests never
  litter the working directory; benches opt in.

Like the tracer, a process-default recorder (``get_recorder`` /
``set_recorder``) lets engines pick one up without threading an
argument through every constructor.  The default is enabled (the whole
point is always-on) but never auto-dumps.
"""
from __future__ import annotations

import json
import threading
import time

__all__ = ["FlightRecorder", "get_recorder", "set_recorder"]


class FlightRecorder:
    def __init__(self, capacity: int = 2048, enabled: bool = True, *,
                 autodump: bool = False, dump_dir: str = ".",
                 storm_threshold: int = 8, storm_window_s: float = 1.0,
                 min_dump_interval_s: float = 5.0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        self.autodump = autodump
        self.dump_dir = dump_dir
        self.storm_threshold = max(1, storm_threshold)
        self.storm_window_s = storm_window_s
        self.min_dump_interval_s = min_dump_interval_s
        self._ring: list = [None] * capacity   # preallocated, overwritten
        self._i = 0                            # next write index
        self._n = 0                            # total events ever recorded
        self._lock = threading.Lock()
        self._pressure_ns: list[int] = []      # recent shed/preempt marks
        self._last_dump_ns: dict[str, int] = {}  # reason -> last trip time
        self.dumps: list[str] = []             # every file this recorder wrote

    # ------------------------------------------------------------- recording
    def record(self, kind: str, name: str, args=None) -> None:
        """Append one event to the ring.  ``kind`` groups the event class
        ("request" / "fault" / "step" / "snapshot" / ...), ``name`` is the
        tracer-compatible event name, ``args`` any JSON-ready payload."""
        if not self.enabled:
            return
        with self._lock:
            self._ring[self._i] = (time.perf_counter_ns(), kind, name, args)
            self._i = (self._i + 1) % self.capacity
            self._n += 1

    def pressure(self) -> bool:
        """Note one shed/preempt pressure mark; True when the recorder has
        seen ``storm_threshold`` marks inside ``storm_window_s`` — the
        caller's cue to ``trip()`` a storm dump."""
        if not self.enabled:
            return False
        now = time.perf_counter_ns()
        horizon = now - int(self.storm_window_s * 1e9)
        with self._lock:
            self._pressure_ns.append(now)
            self._pressure_ns = [t for t in self._pressure_ns if t >= horizon]
            return len(self._pressure_ns) >= self.storm_threshold

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self.capacity
            self._i = 0
            self._n = 0
            self._pressure_ns.clear()

    # -------------------------------------------------------------- reading
    @property
    def recorded(self) -> int:
        """Total events ever recorded (including overwritten ones)."""
        return self._n

    @property
    def dropped(self) -> int:
        """Events the ring has overwritten."""
        return max(0, self._n - self.capacity)

    def events(self) -> list[dict]:
        """Ring contents oldest-first, as JSON-ready dicts."""
        with self._lock:
            if self._n < self.capacity:
                raw = self._ring[:self._n]
            else:
                raw = self._ring[self._i:] + self._ring[:self._i]
        return [{"t_ns": t, "kind": k, "name": n, "args": a}
                for t, k, n, a in raw]

    # -------------------------------------------------------------- dumping
    def dump(self, path: str | None = None, *, reason: str = "manual",
             registry=None, provenance: dict | None = None) -> str:
        """Write the ring (plus an optional metrics snapshot) to a JSON
        file and return its path.  Unconditional — cooldown and the
        ``autodump`` gate live in ``trip()``."""
        if path is None:
            path = f"{self.dump_dir}/FLIGHT_{reason}.json"
        doc = {
            "flight": True,
            "reason": reason,
            "t_dump_ns": time.perf_counter_ns(),
            "clock": "perf_counter_ns",
            "capacity": self.capacity,
            "recorded": self._n,
            "dropped": self.dropped,
            "events": self.events(),
            "metrics": registry.snapshot() if registry is not None else None,
            "provenance": provenance,
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)
        self.dumps.append(path)
        return path

    def trip(self, reason: str, *, registry=None,
             provenance: dict | None = None) -> str | None:
        """The fault ladder's dump hook: writes ``FLIGHT_<reason>.json``
        when ``autodump`` is on and the per-reason cooldown has passed
        (a quarantine storm must not write a thousand files).  Returns
        the path written, or None when suppressed."""
        if not (self.enabled and self.autodump):
            return None
        now = time.perf_counter_ns()
        last = self._last_dump_ns.get(reason)
        if last is not None and now - last < self.min_dump_interval_s * 1e9:
            return None
        self._last_dump_ns[reason] = now
        return self.dump(reason=reason, registry=registry,
                         provenance=provenance)


# the process default: always-on ring, never writes files on its own
_default = FlightRecorder()


def get_recorder() -> FlightRecorder:
    """The process-default flight recorder every engine feeds unless one
    is passed explicitly.  Enabled by default (the recorder exists to be
    always-on) but ``autodump`` is off — only benches/drills that opt in
    via ``set_recorder`` produce FLIGHT_*.json files."""
    return _default


def set_recorder(rec: FlightRecorder | None) -> FlightRecorder:
    """Install (or, with None, reset to a fresh default) the process
    recorder; returns the previous one so callers can restore it."""
    global _default
    prev = _default
    _default = rec if rec is not None else FlightRecorder()
    return prev
