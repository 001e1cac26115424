"""Cluster-runtime policies: heartbeat failure detection, straggler
mitigation, and elastic re-meshing.

On real hardware these hooks sit in the launcher (GKE/Borg restarts, the
JAX coordination service surfaces missing hosts); the *policy* layer is
hardware-independent and fully implemented + tested here:

  * ``StrikePolicy`` — the shared k-consecutive-strikes escalation rule:
    a key trips only after ``patience`` uninterrupted strikes (one clean
    observation resets it).  Both the training-cluster straggler detector
    and the serving engine's stuck-decode watchdog run on this one policy.
  * ``HeartbeatMonitor`` — per-worker liveness with a configurable timeout;
    failed workers are reported to the elastic planner.
  * ``StragglerDetector`` — per-step worker timings vs. rolling median;
    persistent stragglers (> threshold x median for k consecutive steps)
    are treated as soft failures (the cure at scale: drop the node and
    re-mesh, not wait).
  * ``LatencyWatchdog`` — the single-stream form for the serving engine:
    one step-time series vs its own rolling median; a spike streak flags
    a stuck decode loop without any cross-worker comparison.
  * ``plan_elastic_mesh`` — given surviving device count, picks the largest
    valid (pod, data, model) mesh that preserves the model axis (TP degree
    is fixed by the weight shapes) and shrinks data parallelism; the
    checkpoint reshard path (checkpoint/ckpt.py) re-lays the state onto it.
"""
from __future__ import annotations

import dataclasses
import statistics
from collections import deque

__all__ = ["StrikePolicy", "HeartbeatMonitor", "StragglerDetector",
           "LatencyWatchdog", "plan_elastic_mesh", "ElasticPlan"]


class StrikePolicy:
    """k-consecutive-strikes escalation, keyed by an arbitrary id.

    ``strike(key)`` records one violation and returns True when the key
    has accumulated ``patience`` consecutive strikes; ``clear(key)``
    resets it (one clean observation forgives the streak — transient
    blips never escalate, only persistent misbehavior does)."""

    def __init__(self, patience: int = 3):
        self.patience = max(1, patience)
        self._strikes: dict = {}

    def strike(self, key) -> bool:
        self._strikes[key] = self._strikes.get(key, 0) + 1
        return self._strikes[key] >= self.patience

    def clear(self, key) -> None:
        self._strikes[key] = 0

    def strikes(self, key) -> int:
        return self._strikes.get(key, 0)


class HeartbeatMonitor:
    def __init__(self, workers: list, timeout: float = 30.0):
        self.timeout = timeout
        self.last_seen: dict = {w: 0.0 for w in workers}
        self._failed: set = set()

    def beat(self, worker, now: float) -> None:
        if worker in self._failed:
            return
        self.last_seen[worker] = now

    def failed(self, now: float) -> list:
        out = [w for w, t in self.last_seen.items()
               if w not in self._failed and now - t > self.timeout]
        self._failed.update(out)
        return sorted(self._failed)

    def healthy(self, now: float) -> list:
        self.failed(now)
        return [w for w in self.last_seen if w not in self._failed]


class StragglerDetector:
    def __init__(self, threshold: float = 2.0, patience: int = 3):
        self.threshold = threshold
        self.policy = StrikePolicy(patience)

    @property
    def patience(self) -> int:
        return self.policy.patience

    def observe_step(self, timings: dict) -> list:
        """timings: worker -> step seconds.  Returns persistent stragglers."""
        if len(timings) < 2:
            return []
        med = statistics.median(timings.values())
        out = []
        for w, t in timings.items():
            if t > self.threshold * max(med, 1e-9):
                if self.policy.strike(w):
                    out.append(w)
            else:
                self.policy.clear(w)
        return sorted(out)


class LatencyWatchdog:
    """Stuck-decode watchdog for a single step-time stream (the serving
    engine's decode loop): each observation is compared against the
    rolling median of the last ``window`` steps; ``patience`` consecutive
    spikes (> ``threshold`` x median) trip the same ``StrikePolicy`` the
    cluster straggler detector escalates through.

    ``observe(dt)`` returns True exactly when the streak trips — callers
    count flags / surface them in stats; the watchdog itself never kills
    anything (the engine owns the response ladder)."""

    def __init__(self, threshold: float = 3.0, patience: int = 3,
                 window: int = 32, min_samples: int = 4):
        self.threshold = threshold
        self.policy = StrikePolicy(patience)
        self.min_samples = max(1, min_samples)
        self._times: deque = deque(maxlen=max(self.min_samples, window))

    def observe(self, dt: float) -> bool:
        baseline = (statistics.median(self._times)
                    if len(self._times) >= self.min_samples else None)
        spiked = (baseline is not None
                  and dt > self.threshold * max(baseline, 1e-9))
        if spiked:
            tripped = self.policy.strike("decode")
        else:
            self.policy.clear("decode")
            tripped = False
            # only clean steps feed the baseline — a spike streak must not
            # drag the median up and grant itself amnesty
            self._times.append(dt)
        return tripped


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple
    axis_names: tuple
    dropped_devices: int
    note: str


def plan_elastic_mesh(n_healthy: int, model_parallel: int,
                      pod_size: int | None = None) -> ElasticPlan:
    """Largest usable mesh after failures.

    TP degree (``model_parallel``) is pinned by the sharded weight shapes;
    data parallelism absorbs the loss.  With ``pod_size`` set, whole pods
    are the elastic unit (a failed node sidelines its pod's stragglers to
    the spare pool — the standard multi-pod policy)."""
    if n_healthy < model_parallel:
        raise ValueError(
            f"cannot re-mesh: {n_healthy} devices < TP degree "
            f"{model_parallel}")
    if pod_size:
        pods = n_healthy // pod_size
        if pods >= 2:
            data = pod_size // model_parallel
            used = pods * pod_size
            return ElasticPlan((pods, data, model_parallel),
                               ("pod", "data", "model"),
                               n_healthy - used,
                               f"{pods} full pods, data axis {data}")
        n_healthy = min(n_healthy, pod_size)
    data = n_healthy // model_parallel
    used = data * model_parallel
    return ElasticPlan((data, model_parallel), ("data", "model"),
                       n_healthy - used,
                       f"single pod, data axis shrunk to {data}")
