"""Fault tolerance: failure detection, elastic re-meshing, straggler
mitigation and the training restart loop (port of
``repro/runtime/fault_tolerance.py``; pure Python and numpy, the same
policies and reports).

  * ``HeartbeatMonitor`` — each host (for the churn schedules: each
    switch's sketch resource) publishes heartbeats; a host silent for more
    than ``timeout_s`` is declared failed.  The clock is injectable, so
    ``net.simulator.FailureSchedule`` drives it with replay epochs rather
    than wall time and the detection is replayable.
  * ``ElasticMesh`` — the largest mesh of whole data-parallel rows over
    the healthy hosts (the ``model`` axis stays whole); ``MeshPlan`` is
    one such assignment.
  * ``StragglerPolicy`` — a host slower than ``threshold x median`` for
    ``patience`` consecutive steps is quarantined.
  * ``TrainingSupervisor`` — the restart loop: run steps, checkpoint every
    ``ckpt_every``, on failure re-mesh and restore the last checkpoint
    (``SupervisorReport``).  The step, save and restore functions are
    injected: the tests drive it with a failing step function.  As in the
    reference, ``launch/train.py`` does not use it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np


class HeartbeatMonitor:
    """Failure detection from host heartbeats (injectable clock)."""

    def __init__(self, n_hosts: int, timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.n_hosts = n_hosts
        self.timeout_s = timeout_s
        self.clock = clock
        now = clock()
        self._last: Dict[int, float] = {h: now for h in range(n_hosts)}

    def beat(self, host: int) -> None:
        if not 0 <= host < self.n_hosts:
            raise ValueError(
                f"host {host} out of range [0, {self.n_hosts})")
        self._last[host] = self.clock()

    def failed_hosts(self) -> Set[int]:
        now = self.clock()
        return {h for h, t in self._last.items()
                if now - t > self.timeout_s}

    def healthy_hosts(self) -> List[int]:
        bad = self.failed_hosts()
        return [h for h in range(self.n_hosts) if h not in bad]


@dataclass
class MeshPlan:
    """A concrete mesh assignment over healthy hosts."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    hosts: Tuple[int, ...]           # hosts participating, row-major

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.shape))


class ElasticMesh:
    """Largest-rectangle re-meshing under host failures.

    ``devices_per_host`` devices per host; the model axis must stay whole
    (it shards one replica), so the unit of removal is a data-parallel
    row = ``model_axis / devices_per_host`` hosts.
    """

    def __init__(self, pod: int, data: int, model: int,
                 devices_per_host: int = 4):
        self.pod, self.data, self.model = pod, data, model
        self.devices_per_host = devices_per_host
        self.hosts_per_row = max(model // devices_per_host, 1)
        self.rows = pod * data          # data-parallel rows
        self.n_hosts = self.rows * self.hosts_per_row

    def row_of_host(self, host: int) -> int:
        return host // self.hosts_per_row

    def plan(self, healthy: Sequence[int]) -> MeshPlan:
        """Build the largest mesh from healthy hosts (whole rows only)."""
        healthy_set = set(healthy)
        rows = [r for r in range(self.rows)
                if all(r * self.hosts_per_row + i in healthy_set
                       for i in range(self.hosts_per_row))]
        if not rows:
            raise RuntimeError("no complete data-parallel row is healthy")
        # Prefer whole-pod grouping ONLY when it doesn't cost capacity:
        # a flat (data, model) mesh over all healthy rows keeps more
        # devices whenever any pod is partially degraded.
        usable = len(rows)
        per_pod = self.data
        pods_complete = [p for p in range(self.pod)
                         if sum(1 for r in rows
                                if r // per_pod == p) == per_pod]
        if pods_complete and len(pods_complete) * per_pod == usable:
            shape = (len(pods_complete), self.data, self.model)
            names = ("pod", "data", "model")
            sel = [r for r in rows if r // per_pod in pods_complete]
        else:
            # degrade to a flat (data, model) mesh over all healthy rows
            shape = (usable, self.model)
            names = ("data", "model")
            sel = rows
        hosts = tuple(r * self.hosts_per_row + i for r in sel
                      for i in range(self.hosts_per_row))
        return MeshPlan(shape, names, hosts)


class StragglerPolicy:
    """Quarantine hosts that are persistently slower than the fleet."""

    def __init__(self, threshold: float = 1.5, patience: int = 3):
        self.threshold = threshold
        self.patience = patience
        self._slow_streak: Dict[int, int] = {}
        self.quarantined: Set[int] = set()

    def observe(self, step_times: Dict[int, float]) -> Set[int]:
        """Feed per-host step durations; returns hosts to quarantine now."""
        # The median must be taken over non-quarantined hosts only: a
        # quarantined slow host left in the sample drags the median up and
        # shields every other straggler from the threshold test.
        active = [t for h, t in step_times.items()
                  if h not in self.quarantined]
        if not active:
            return set()
        med = float(np.median(active))
        newly = set()
        for h, t in step_times.items():
            if h in self.quarantined:
                continue
            if t > self.threshold * max(med, 1e-9):
                self._slow_streak[h] = self._slow_streak.get(h, 0) + 1
                if self._slow_streak[h] >= self.patience:
                    self.quarantined.add(h)
                    newly.add(h)
            else:
                self._slow_streak[h] = 0
        return newly

    def readmit(self, host: int) -> None:
        self.quarantined.discard(host)
        self._slow_streak[host] = 0


@dataclass
class SupervisorReport:
    steps_done: int
    restarts: int
    final_mesh: Tuple[int, ...]
    events: List[str] = field(default_factory=list)


class TrainingSupervisor:
    """Checkpoint/restart loop around an injectable step function.

    ``step_fn(step, mesh_plan) -> None`` raises ``RuntimeError`` on a
    simulated/real collective failure.  ``save_fn(step)`` / ``restore_fn()
    -> step`` bind to ckpt/checkpoint.py in a real launcher.
    """

    def __init__(self, elastic: ElasticMesh, monitor: HeartbeatMonitor,
                 *, ckpt_every: int = 50, max_restarts: int = 8):
        self.elastic = elastic
        self.monitor = monitor
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts

    def run(self, n_steps: int, step_fn, save_fn, restore_fn,
            straggler: Optional[StragglerPolicy] = None,
            timings_fn=None) -> SupervisorReport:
        events: List[str] = []
        restarts = 0
        plan = self.elastic.plan(self.monitor.healthy_hosts())
        step = restore_fn()
        while step < n_steps:
            try:
                step_fn(step, plan)
                if straggler is not None and timings_fn is not None:
                    slow = straggler.observe(timings_fn(step))
                    if slow:
                        events.append(f"step {step}: quarantined {sorted(slow)}")
                        healthy = [h for h in self.monitor.healthy_hosts()
                                   if h not in straggler.quarantined]
                        plan = self.elastic.plan(healthy)
                        save_fn(step)
                step += 1
                if step % self.ckpt_every == 0:
                    save_fn(step)
            except RuntimeError as e:
                restarts += 1
                events.append(f"step {step}: failure '{e}', re-meshing")
                if restarts > self.max_restarts:
                    raise
                healthy = self.monitor.healthy_hosts()
                if straggler is not None:
                    healthy = [h for h in healthy
                               if h not in straggler.quarantined]
                plan = self.elastic.plan(healthy)
                step = restore_fn()
        save_fn(step)
        return SupervisorReport(step, restarts, plan.shape, events)
