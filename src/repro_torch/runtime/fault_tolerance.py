"""Failure detection from heartbeats (port of
``repro/runtime/fault_tolerance.py``'s ``HeartbeatMonitor``).

Each host (here: each switch's sketch resource) publishes heartbeats; a
host silent for more than ``timeout_s`` is declared failed.  The clock is
injectable, so ``net.simulator.FailureSchedule`` drives it with replay
epochs rather than wall time and the detection is replayable.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Set


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
