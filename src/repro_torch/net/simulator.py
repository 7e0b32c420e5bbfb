"""Epoch-driven replay engine (port of ``repro/net/simulator.py``'s
``Replayer``): feeds per-switch packet streams to a system, one epoch or
one epoch window at a time.

For every switch it precomputes the packets whose path traverses it, split
by epoch (the split uses timestamps, so subepoch semantics are exact).
Churn comes from event sources with one ``advance(epoch)`` each:
``FailureSchedule`` (switch deaths and recoveries, detected through a
heartbeat monitor), ``ResourcePressure`` (co-resident apps grabbing and
releasing SRAM) and ``ComposedSchedule`` (several sources at once);
``Replayer.run(system, failures=...)`` feeds their events to the system.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.disketch import SwitchStream
from ..runtime.fault_tolerance import HeartbeatMonitor
from .traffic import Workload


@dataclass(frozen=True)
class FailureEvent:
    """One churn event, consumed by ``DiSketchSystem.apply_event``.

    ``kind``: "fail" (sketch resource reclaimed; the switch keeps
    forwarding), "recover" (resource returned; the fragment restarts at
    n_0 = 1), "shrink" (memory times ``factor`` <= 1) or "grow" (memory
    times ``factor`` > 1: a co-resident app released SRAM).
    """
    epoch: int
    switch: int
    kind: str
    factor: float = 1.0


class _EpochClock:
    """Injectable clock stepping ``epoch_s`` seconds per replay epoch."""

    def __init__(self, epoch_s: float):
        self.epoch_s = epoch_s
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


class FailureSchedule:
    """Scripted switch churn, *detected* through a heartbeat monitor.

    The schedule holds the ground truth (``downs[sw] = (down_epoch,
    up_epoch | None)`` and scripted resizes), but emits what the control
    plane can observe: each ``advance(epoch)`` steps the clock by
    ``epoch_s``, beats every up switch into a ``HeartbeatMonitor`` and
    turns its timeout transitions into "fail"/"recover" events.  With the
    default ``timeout_s = 0.75 * epoch_s`` a death is detected in the
    first epoch the switch misses; a larger timeout models detection lag
    (the epochs before detection stay unmasked).  Deterministic: the
    clock belongs to the schedule (or is injected), never wall time.
    """

    def __init__(self, n_switches: int,
                 downs: Optional[Dict[int, Tuple[int, Optional[int]]]] = None,
                 shrinks: Optional[Sequence[Tuple[int, int, float]]] = None,
                 *, epoch_s: float = 1.0,
                 timeout_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.n_switches = n_switches
        self.downs: Dict[int, Tuple[int, Optional[int]]] = dict(downs or {})
        for sw, (d, u) in self.downs.items():
            if not 0 <= sw < n_switches:
                raise ValueError(f"switch {sw} out of range "
                                 f"[0, {n_switches})")
            if u is not None and u <= d:
                raise ValueError(f"switch {sw}: up epoch {u} must follow "
                                 f"down epoch {d}")
        self._shrinks: Dict[int, List[FailureEvent]] = {}
        for ep, sw, factor in (shrinks or ()):
            # factor <= 1 reclaims memory ("shrink"), > 1 returns it
            # ("grow"): §6's residual resources change both ways
            if not factor > 0.0:
                raise ValueError(f"resize factor {factor} must be > 0")
            kind = "shrink" if factor <= 1.0 else "grow"
            self._shrinks.setdefault(int(ep), []).append(
                FailureEvent(int(ep), int(sw), kind, float(factor)))
        self.epoch_s = epoch_s
        self._clock = clock if clock is not None else _EpochClock(epoch_s)
        self._own_clock = clock is None
        self.monitor = HeartbeatMonitor(
            n_switches,
            timeout_s=0.75 * epoch_s if timeout_s is None else timeout_s,
            clock=self._clock)
        self._known_dead: set = set()
        self.log: List[FailureEvent] = []

    def is_up(self, sw: int, epoch: int) -> bool:
        """Ground truth (the monitor may not have detected it yet)."""
        d_u = self.downs.get(sw)
        if d_u is None:
            return True
        d, u = d_u
        return epoch < d or (u is not None and epoch >= u)

    def advance(self, epoch: int) -> List[FailureEvent]:
        """The churn events *detected* at ``epoch``'s start."""
        if self._own_clock:
            self._clock.t = epoch * self.epoch_s
        for sw in range(self.n_switches):
            if self.is_up(sw, epoch):
                self.monitor.beat(sw)
        failed = self.monitor.failed_hosts()
        events: List[FailureEvent] = []
        for sw in sorted(failed - self._known_dead):
            events.append(FailureEvent(epoch, sw, "fail"))
        for sw in sorted(self._known_dead - failed):
            events.append(FailureEvent(epoch, sw, "recover"))
        self._known_dead = set(failed)
        events.extend(self._shrinks.get(epoch, ()))
        self.log.extend(events)
        return events

    @classmethod
    def random(cls, n_switches: int, frac_failed: float, *,
               down_epoch: int, up_epoch: Optional[int] = None,
               seed: int = 0, **kw) -> "FailureSchedule":
        """Kill a random ``frac_failed`` of the switches at ``down_epoch``
        (recovering at ``up_epoch`` if given)."""
        rng = np.random.default_rng(seed)
        k = int(round(frac_failed * n_switches))
        victims = rng.choice(n_switches, size=k, replace=False)
        downs = {int(sw): (down_epoch, up_epoch) for sw in victims}
        return cls(n_switches, downs, **kw)


class ResourcePressure:
    """Time-varying contention from co-resident switch apps (§6: a
    fragment lives in *residual* SRAM that other apps also claim).

    At each epoch a seeded per-switch process may grab a fraction of the
    fragment's memory (a "shrink" with factor ``1 - grab``), hold it a few
    epochs, then release it (a "grow" with factor ``1 / (1 - grab)``); at
    most one grab is in flight per switch.  The events are generated at
    construction from ``seed``, so two instances with the same arguments
    emit the same stream.  Memory is whole bytes, so a grab and its
    release restore the width only up to ``int()`` truncation.
    """

    def __init__(self, n_switches: int, *, horizon: int, seed: int = 0,
                 p_grab: float = 0.15,
                 grab_frac: Tuple[float, float] = (0.3, 0.7),
                 hold: Tuple[int, int] = (1, 4)):
        if not 0.0 <= p_grab <= 1.0:
            raise ValueError(f"p_grab={p_grab} not in [0, 1]")
        lo, hi = grab_frac
        if not 0.0 < lo <= hi < 1.0:
            raise ValueError(f"grab_frac range {grab_frac} not in (0, 1)")
        h_lo, h_hi = int(hold[0]), int(hold[1])
        if h_lo < 1 or h_hi < h_lo:
            raise ValueError(f"hold range {hold} invalid")
        self.n_switches = int(n_switches)
        self.horizon = int(horizon)
        rng = np.random.default_rng(seed)
        self._events: Dict[int, List[FailureEvent]] = {}
        for sw in range(self.n_switches):
            busy_until = 0
            for ep in range(self.horizon):
                if ep < busy_until or rng.random() >= p_grab:
                    continue
                grab = float(rng.uniform(lo, hi))
                release = ep + int(rng.integers(h_lo, h_hi + 1))
                self._events.setdefault(ep, []).append(
                    FailureEvent(ep, sw, "shrink", 1.0 - grab))
                if release < self.horizon:
                    self._events.setdefault(release, []).append(
                        FailureEvent(release, sw, "grow",
                                     1.0 / (1.0 - grab)))
                busy_until = release
        self.log: List[FailureEvent] = []

    def advance(self, epoch: int) -> List[FailureEvent]:
        events = list(self._events.get(int(epoch), ()))
        self.log.extend(events)
        return events


class ComposedSchedule:
    """Several event sources (``FailureSchedule``, ``ResourcePressure``,
    ...) behind one ``advance(epoch)``; each epoch's events come in
    schedule order."""

    def __init__(self, schedules: Sequence):
        self.schedules = list(schedules)
        self.log: List[FailureEvent] = []

    def advance(self, epoch: int) -> List[FailureEvent]:
        events: List[FailureEvent] = []
        for s in self.schedules:
            events.extend(s.advance(epoch))
        self.log.extend(events)
        return events


class Replayer:
    def __init__(self, wl: Workload, n_switches: int,
                 packet_cache: int = 8):
        self.wl = wl
        self.n_switches = n_switches
        # Packed-epoch LRU capacity (8 epochs ≈ two 4-epoch windows): an
        # unbounded cache would hold the whole trace over a long replay.
        self.packet_cache = packet_cache
        pkt_keys = wl.pkt_keys
        single_hop_flow = wl.path_len == 1
        epoch_of = (wl.pkt_ts >> wl.log2_te).astype(np.int64)
        self._streams: List[Dict[int, SwitchStream]] = [
            {} for _ in range(wl.n_epochs)]
        # (epoch, frag_order) -> FleetPacket, LRU-evicted
        self._packets: "OrderedDict" = OrderedDict()
        for sw in range(n_switches):
            on_path = (wl.path_mat == sw).any(axis=1)  # per flow
            pkt_sel = on_path[wl.pkt_flow]
            if not pkt_sel.any():
                continue
            idx = np.nonzero(pkt_sel)[0]
            e = epoch_of[idx]
            order = np.argsort(e, kind="stable")
            idx = idx[order]
            bounds = np.searchsorted(e[order], np.arange(wl.n_epochs + 1))
            for ep in range(wl.n_epochs):
                lo, hi = bounds[ep], bounds[ep + 1]
                if lo == hi:
                    continue
                sl = idx[lo:hi]
                self._streams[ep][sw] = SwitchStream(
                    keys=pkt_keys[sl],
                    values=np.ones(len(sl), dtype=np.int64),
                    ts=wl.pkt_ts[sl],
                    single_hop=single_hop_flow[wl.pkt_flow[sl]],
                )

    def run(self, system, window: int = 1, failures=None) -> None:
        """Replay every epoch through ``system``.

        ``window=1`` (the default) runs the paper's per-epoch control:
        ``system.run_epoch`` epoch by epoch, fleet-backed systems getting
        the cached packed epoch (``epoch_packet``).  ``window=E`` on a
        fleet-backed system batches E consecutive epochs into one
        super-dispatch (``system.run_window``; ``ns`` frozen per window,
        the tail window may be shorter); systems without a fleet run
        epoch by epoch whatever the window.  ``failures`` (an event
        source such as ``FailureSchedule``) is advanced alongside the
        replay and its events go to the system with their epoch.
        """
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        fleet = getattr(system, "fleet", None)
        if window > 1 and fleet is not None:
            order = fleet.frag_order
            for e0 in range(0, self.wl.n_epochs, window):
                eps = range(e0, min(e0 + window, self.wl.n_epochs))
                kw = {}
                if failures is not None:
                    kw["events_by_epoch"] = [failures.advance(e)
                                             for e in eps]
                    if any(kw["events_by_epoch"]):
                        # churn reprocesses these epochs: rebuild their
                        # packets from the pristine streams
                        self.invalidate_packets(eps)
                system.run_window(e0, [self._streams[e] for e in eps],
                                  packets=[self.epoch_packet(e, order)
                                           for e in eps], **kw)
            return
        for ep in range(self.wl.n_epochs):
            kw = {}
            if failures is not None:
                kw["events"] = failures.advance(ep)
                if kw["events"]:
                    self.invalidate_packets([ep])
            if fleet is not None:
                system.run_epoch(ep, self._streams[ep],
                                 packet=self.epoch_packet(
                                     ep, fleet.frag_order), **kw)
            else:
                system.run_epoch(ep, self._streams[ep], **kw)

    def epoch_stream(self, epoch: int) -> Dict[int, SwitchStream]:
        return self._streams[epoch]

    def invalidate_packets(self, epochs) -> int:
        """Evict the packed-epoch LRU entries of ``epochs`` (every
        ``frag_order``); returns how many went.  ``run`` calls it when
        churn reprocesses epochs: the packed arrays are shared across
        systems and replays, so an entry a caller changed, or one paired
        with superseded churn state, is rebuilt from the streams."""
        eset = set(int(e) for e in epochs)
        victims = [k for k in self._packets if k[0] in eset]
        for k in victims:
            del self._packets[k]
        return len(victims)

    def epoch_packet(self, epoch: int, frag_order=None):
        """Packed fragment-major packets of one epoch for the fleet engine,
        in ``frag_order`` (default: all switches in id order), cached in an
        LRU of ``packet_cache`` epochs."""
        from ..core.fleet import pack_streams

        if frag_order is None:
            frag_order = tuple(range(self.n_switches))
        frag_order = tuple(frag_order)
        key = (epoch, frag_order)
        pkt = self._packets.get(key)
        if pkt is None:
            pkt = pack_streams(self._streams[epoch], frag_order)
            self._packets[key] = pkt
            while len(self._packets) > self.packet_cache:
                self._packets.popitem(last=False)
        else:
            self._packets.move_to_end(key)
        return pkt


def rmse(est: np.ndarray, truth: np.ndarray) -> float:
    e = np.asarray(est, dtype=np.float64) - np.asarray(truth,
                                                       dtype=np.float64)
    return float(np.sqrt(np.mean(e * e)))


def nrmse(est: np.ndarray, truth: np.ndarray, total: float) -> float:
    """Paper §6.3: RMSE normalized by the total packet count."""
    return rmse(est, truth) / max(float(total), 1.0)


def are(est: np.ndarray, truth: np.ndarray) -> float:
    """Average relative error over the queried flows."""
    t = np.maximum(np.asarray(truth, dtype=np.float64), 1.0)
    return float(np.mean(np.abs(np.asarray(est) - truth) / t))
