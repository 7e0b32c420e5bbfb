"""Chaos harness: every failure plane composed, invariants machine-checked
(port of ``repro/runtime/chaos.py``).

Switch churn (``net.simulator.FailureSchedule``), lossy at-least-once export
(``runtime.export.DurableExportPlane``), a lossy versioned control plane
(``runtime.control.VersionedControlPlane``) and two-way resource pressure
(``net.simulator.ResourcePressure``) each hold on their own; the claim is
that they compose.  This module runs one seeded scenario with all of them
armed at once and checks the composition's invariants after every
dispatch:

* **Cell partition** — every cell ever staged for export is, at all
  times, exactly one of *applied* (delivered and merged), *pending*
  (still being retried) or *lost* (retry budget spent); after the final
  drain, ``applied ⊎ lost`` partitions the staged set — nothing is
  silently truncated, also across collector crashes.
* **Stale-config ledger** — the control plane's per-epoch stale-config
  record is recomputed on its own from ``applied_log`` / ``intent_log``:
  an epoch is stale exactly when the config its dispatch ran differed from
  the controller's intent at issue time.
* **Config-twin counters** — a fresh external-control system, set before
  each dispatch to the *applied* (not intended) config and replaying the
  same streams and churn events, must reproduce every applied cell's
  counters bit for bit: a lossy control channel makes configs stale,
  never counters wrong (``verify_config_twin``).
* **Loss-free oracle** — with every channel lossless and no crashes or
  pressure, the composed stack is bit-identical to a bare system
  (``cells_equal`` and a query comparison, in the tests).

The harness duck-types the system interface (``run_epoch``,
``run_window``, ``fleet``, ``fragments``), so ``Replayer.run(harness,
window=E, failures=schedule)`` drives the whole stack: the schedule's
events flow through the planes into the system while the harness
snapshots the staged cells, advances the export protocol, injects the
scripted collector crashes and checks the invariants.

A cell is the fleet's live ``(n_levels, n, width)`` int32 block
(``FleetEpochRunner.cell_counters``) or the loop backend's int64 record;
``cells_equal`` compares cells within one backend.  The harness is host
Python; the dispatches it wraps run the system's own kernels.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Set, Tuple

import numpy as np

from .control import VersionedControlPlane
from .export import DurableExportPlane


class ChaosInvariantError(AssertionError):
    """A machine-checked chaos invariant failed."""


def _cell(system, sw: int, epoch: int) -> np.ndarray:
    """One (switch, epoch) cell's exact counters, either backend."""
    if system.fleet is not None:
        return np.asarray(system.fleet.cell_counters(epoch, sw))
    return np.asarray(system.records[epoch][sw].counters)


def cells_equal(sys_a, sys_b, cells: Sequence[Tuple[int, int]]) -> bool:
    """Are the given (switch, epoch) cells bit-identical across two
    systems (either backend each)?"""
    return all(np.array_equal(_cell(sys_a, sw, e), _cell(sys_b, sw, e))
               for sw, e in cells)


class ChaosHarness:
    """Drive a composed failure stack under invariant checks.

    Parameters
    ----------
    plane :
        The outermost plane: ``VersionedControlPlane`` (optionally around
        a ``DurableExportPlane``), a bare ``DurableExportPlane``, or a bare
        system — the harness arms the invariants that apply to what it
        finds.
    steps_per_dispatch : int
        Export protocol rounds after each dispatch (the export plane itself
        must run with ``steps_per_dispatch=0``, so the harness can snapshot
        the staged cells before a checkpoint releases them).
    crash_every : int
        Crash (and recover) the collector every N dispatches (0 = never).
    """

    def __init__(self, plane, *, steps_per_dispatch: int = 6,
                 crash_every: int = 0):
        self.plane = plane
        self.control: Optional[VersionedControlPlane] = None
        inner = plane
        if isinstance(plane, VersionedControlPlane):
            self.control = plane
            inner = plane.inner
        self.export: Optional[DurableExportPlane] = (
            inner if isinstance(inner, DurableExportPlane) else None)
        if self.export is not None and self.export.steps_per_dispatch:
            raise ValueError(
                "configure the export plane with steps_per_dispatch=0: "
                "the harness must snapshot staged cells before a "
                "checkpoint can release them")
        if crash_every and self.export is None:
            raise ValueError("crash_every needs an export plane")
        self.system = getattr(plane, "system", plane)
        self.steps_per_dispatch = int(steps_per_dispatch)
        self.crash_every = int(crash_every)
        self.staged: Set[Tuple[int, int]] = set()
        # the config twin's replay tape: one entry per dispatch
        self._tape: List[Tuple[str, int, list, Optional[list]]] = []
        self._dispatch_epochs: List[List[int]] = []
        self._dispatch_dead: List[Set[int]] = []
        self.crash_log: List[dict] = []
        self.n_dispatches = 0

    # -- the system's face (Replayer.run drives the harness) ---------------

    @property
    def fleet(self):
        return self.plane.fleet

    @property
    def fragments(self):
        return self.plane.fragments

    @property
    def records(self):
        return self.plane.records

    @property
    def kind(self):
        return self.plane.kind

    def query_flows(self, keys, paths, epochs, **kw):
        return self.plane.query_flows(keys, paths, epochs, **kw)

    def query_entropy(self, keys, paths, epochs, total, **kw):
        return self.plane.query_entropy(keys, paths, epochs, total, **kw)

    @property
    def last_observability(self):
        return self.plane.last_observability

    # -- dispatches --------------------------------------------------------

    def run_epoch(self, epoch: int, streams, packet=None, events=None
                  ) -> None:
        self._dispatch_dead.append(set(self.system.dead))
        self.plane.run_epoch(epoch, streams, packet=packet, events=events)
        self._after_dispatch(
            [epoch], ("epoch", epoch, streams,
                      list(events) if events else None))

    def run_window(self, epoch0: int, streams_list, packets=None,
                   events_by_epoch=None) -> None:
        self._dispatch_dead.append(set(self.system.dead))
        self.plane.run_window(epoch0, streams_list, packets=packets,
                              events_by_epoch=events_by_epoch)
        evs = ([list(e) for e in events_by_epoch]
               if events_by_epoch else None)
        self._after_dispatch(
            list(range(epoch0, epoch0 + len(streams_list))),
            ("window", epoch0, list(streams_list), evs))

    def _after_dispatch(self, epochs: List[int], tape_entry) -> None:
        if self.export is not None:
            for sw, exp in self.export.exporters.items():
                self.staged.update((sw, e) for e in exp.entries)
        self._tape.append(tape_entry)
        self._dispatch_epochs.append(epochs)
        self.n_dispatches += 1
        if self.export is not None:
            for _ in range(self.steps_per_dispatch):
                self.export.step()
            if (self.crash_every
                    and self.n_dispatches % self.crash_every == 0):
                self.crash_log.append(self.export.crash())
        self.check_partition(final=False)

    # -- invariants --------------------------------------------------------

    def check_partition(self, final: bool) -> None:
        """Applied ⊎ lost (⊎ pending mid-run) covers every staged cell,
        with applied and lost disjoint."""
        if self.export is None:
            return
        applied = set(self.export.collector.applied)
        lost = self.export.lost_cells()
        pending = self.export.pending_cells()
        if applied & lost:
            raise ChaosInvariantError(
                f"cells both applied and lost: {sorted(applied & lost)}")
        if not applied <= self.staged:
            raise ChaosInvariantError(
                f"applied cells never staged: "
                f"{sorted(applied - self.staged)}")
        missing = self.staged - (applied | lost | pending)
        if missing:
            raise ChaosInvariantError(
                f"staged cells silently unaccounted (not applied, "
                f"pending, or lost): {sorted(missing)}")
        if final and pending:
            raise ChaosInvariantError(
                f"cells still pending after final drain: "
                f"{sorted(pending)}")

    def check_stale_ledger(self) -> None:
        """Recompute the stale-config epochs on their own: dispatch d ran
        stale for switch s iff the config it applied differs from the
        controller's intent standing when it was dispatched (the intent
        issued after dispatch d - 1)."""
        ctl = self.control
        if ctl is None:
            return
        for d, epochs in enumerate(self._dispatch_epochs):
            applied = ctl.applied_log[d]
            if d == 0:
                expect: List[int] = []
            else:
                intent = ctl.intent_log[d - 1]
                dead = self._dispatch_dead[d]
                expect = sorted(
                    sw for sw in applied
                    if sw not in dead
                    and applied[sw] != intent.get(sw, applied[sw]))
            for e in epochs:
                got = ctl._epoch_stale.get(e, [])
                if list(got) != expect:
                    raise ChaosInvariantError(
                        f"stale-config ledger wrong at epoch {e}: "
                        f"recorded {got}, recomputed {expect}")

    def verify_config_twin(self, make_system: Callable[[], object]
                           ) -> int:
        """Replay the run on a fresh external-control system pinned to the
        *applied* config of every dispatch; every applied cell must match
        bit for bit.  Returns the number of cells compared.

        This is the check that a lossy control channel never corrupts
        counters: if any query-visible counter depended on the
        controller's undelivered *intent* rather than the applied config,
        the twin would diverge.
        """
        ctl = self.control
        if ctl is None:
            raise ValueError("verify_config_twin needs a control plane")
        twin = make_system()
        twin.control_external = True
        for d, entry in enumerate(self._tape):
            twin.ns.update(ctl.applied_log[d])
            if entry[0] == "window":
                _, e0, streams_list, evs = entry
                twin.run_window(e0, streams_list, events_by_epoch=evs)
            else:
                _, e, streams, evs = entry
                twin.run_epoch(e, streams, events=evs)
        applied = (set(self.export.collector.applied)
                   if self.export is not None else
                   {(sw, e) for e in self.system.records
                    for sw in self.system.records[e]})
        bad = [c for c in sorted(applied)
               if not np.array_equal(_cell(self.system, *c),
                                     _cell(twin, *c))]
        if bad:
            raise ChaosInvariantError(
                f"applied cells diverge from the applied-config twin "
                f"(counters corrupted by control loss): {bad[:8]}")
        return len(applied)

    # -- teardown ----------------------------------------------------------

    def finish(self, max_rounds: int = 10_000) -> dict:
        """Drain every plane, run the final invariant checks, and return
        the scenario's report."""
        if self.export is not None:
            self.export.drain(max_rounds)
        if self.control is not None:
            self.control.drain(max_rounds)
        self.check_partition(final=True)
        self.check_stale_ledger()
        report = {
            "dispatches": self.n_dispatches,
            "staged": len(self.staged),
            "crashes": len(self.crash_log),
        }
        if self.export is not None:
            report["applied"] = len(self.export.collector.applied)
            report["lost"] = sorted(self.export.lost_cells())
            report["export"] = self.export.stats()
        if self.control is not None:
            report["stale_epochs"] = self.control.stale_epochs()
            report["n_stale_epochs"] = len(self.control.stale_epochs())
            report["n_directives"] = self.control.n_directives
            report["n_clamps"] = len(self.control.clamp_log)
            report["max_version_lag"] = max(
                self.control.version_lag().values(), default=0)
        return report
