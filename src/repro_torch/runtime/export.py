"""Durable export plane: at-least-once fragment collection (port of
``repro/runtime/export.py``).

The paper's fragments only become a network-wide view once their
counters are *exported* to the collector at period boundaries.  This
module models that path as lossy, delayed and backed by a collector that
can crash:

* **Wire protocol** — each (fragment, epoch) cell is carried by
  sequence-numbered ``ExportMsg``s over a ``net.channel.LossyChannel``;
  the collector ACKs every copy it sees (``AckMsg``), deduplicates by
  ``(frag, epoch, seq)``, and applies each cell exactly once.  The
  switch side (``SwitchExporter``) retransmits with capped exponential
  backoff under a bounded retry budget; an exhausted budget permanently
  hands the cell to the ``failures="mask"`` machinery as *lost*
  (blind-epoch extrapolation) — never silently truncated.

* **Collector model** — ``DurableExportPlane`` wraps a
  ``DiSketchSystem`` and is duck-typed as one (``.fleet``,
  ``run_epoch``, ``run_window``, ``query_flows``, ``query_entropy``),
  so ``Replayer.run(plane, window=E, failures=schedule)`` composes
  switch churn with collection loss unchanged.  After each dispatch the
  freshly sketched cells are *held back* from the system — zeroed and
  masked in the fleet's retained window (``mark_unexported``), or
  popped from the loop backend's record dict — and patched back in
  place as their messages arrive (``deliver_cell`` / record
  reinsertion), so late arrivals sharpen every later query.

* **Durability** — ``checkpoint()`` atomically persists the applied
  cells + protocol state (``ckpt.checkpoint``); a committed checkpoint
  is the release watermark for switch-side payload retention.
  ``crash()`` drops all un-checkpointed collector state and every
  in-flight message, restores the last committed step, then re-syncs:
  retained cells the restored collector lacks are re-staged with a
  fresh budget (covering the delivered-and-ACKed-after-checkpoint
  window — the at-least-once core), cells it has are re-ACKed.  Once
  the channel drains, the recovered collector is **bit-identical** to a
  crash-free run: counters are exact integers (< 2^24), payloads are
  exact int32, and the control loop (PEBs, subepoch counts) rides the
  dispatch path, which models the paper's piggybacked reliable control
  channel.

A message's fate depends on ``(channel seed, frag, epoch, seq)`` alone,
and exporters send in sorted (switch, epoch) order, so the protocol's
trace depends only on which cells were staged and when, never on their
counters or shapes.  The fleet's payloads are each cell's live
``(n_levels, n, width)`` block (the reference pads them to the window's
``(n_sub_max, width_max)``); payloads stay host numpy int32 on the wire.

Composition limits (loud, not silent): the fleet backend is supported
in *window mode* (a retained window is what the plane patches);
XOR-parity groups are mutually exclusive with the export plane (parity
reconstruction XORs the *current* window rows, which pending-export
zeroing would corrupt).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..net.channel import LossyChannel


@dataclass
class ExportMsg:
    """One export attempt of one (fragment, epoch) cell.  ``seq`` is the
    attempt index — each retransmission is a fresh sequence number, so
    the channel draws an independent fate per attempt and the collector
    can dedup exact duplicates while still re-ACKing them."""
    frag: int
    epoch: int
    seq: int
    payload: np.ndarray         # int32 counters (exact under the 2^24
    #                             f32 integer contract)


@dataclass
class AckMsg:
    """Collector acknowledgment of one received ``ExportMsg``."""
    frag: int
    epoch: int
    seq: int


@dataclass
class _Entry:
    payload: np.ndarray
    attempts: int = 0
    next_send: int = 0
    acked: bool = False


class SwitchExporter:
    """Switch-side export state machine for one fragment.

    Retains every staged payload until the collector *commits* it (a
    checkpoint containing the cell releases it) — an ACK alone is not
    enough, because an ACKed-but-uncheckpointed cell dies with a
    collector crash and must be retransmittable.  Retransmission uses
    capped exponential backoff: attempt ``k`` (0-based) waits
    ``min(backoff0 * 2**k, backoff_max)`` rounds before attempt
    ``k + 1``.  After ``1 + max_retries`` unACKed attempts the entry is
    *exhausted*: the exporter gives up and the cell is reported lost
    (unless a stale in-flight copy still lands).
    """

    def __init__(self, frag: int, *, max_retries: int = 8,
                 backoff0: int = 1, backoff_max: int = 8):
        if max_retries < 0 or backoff0 < 1 or backoff_max < backoff0:
            raise ValueError("need max_retries >= 0 and "
                             "1 <= backoff0 <= backoff_max")
        self.frag = int(frag)
        self.max_retries = int(max_retries)
        self.backoff0 = int(backoff0)
        self.backoff_max = int(backoff_max)
        self.entries: Dict[int, _Entry] = {}
        self.n_tx = 0               # total ExportMsg sends (retransmit
        #                             volume accounting)

    def stage(self, epoch: int, payload: np.ndarray, now: int) -> None:
        self.entries[int(epoch)] = _Entry(payload=payload, next_send=now)

    def _exhausted(self, ent: _Entry) -> bool:
        return not ent.acked and ent.attempts > self.max_retries

    def tick(self, now: int, channel: LossyChannel) -> None:
        """(Re)transmit every due, unACKed, unexhausted entry."""
        for epoch in sorted(self.entries):
            ent = self.entries[epoch]
            if ent.acked or self._exhausted(ent) or ent.next_send > now:
                continue
            channel.send(ExportMsg(self.frag, epoch, ent.attempts,
                                   ent.payload), now)
            self.n_tx += 1
            ent.attempts += 1
            ent.next_send = now + min(self.backoff0
                                      * (1 << (ent.attempts - 1)),
                                      self.backoff_max)

    def on_ack(self, epoch: int) -> None:
        ent = self.entries.get(int(epoch))
        if ent is not None:
            ent.acked = True

    def release(self, epoch: int) -> None:
        """Drop the payload — the collector durably committed it."""
        self.entries.pop(int(epoch), None)

    def resync(self, applied: Set[Tuple[int, int]], now: int) -> List[int]:
        """Collector-recovery beacon: re-ACK retained cells the restored
        collector has; re-stage (fresh budget, immediate send) the ones
        it lost.  Exhausted entries stay exhausted — their loss was
        already reported and must not silently change.  Returns the
        re-staged epochs."""
        restaged = []
        for epoch, ent in self.entries.items():
            if (self.frag, epoch) in applied:
                ent.acked = True
            elif not self._exhausted(ent):
                ent.acked = False
                ent.attempts = 0
                ent.next_send = now
                restaged.append(epoch)
        return restaged

    def unfinished(self) -> List[int]:
        """Epochs still being retried (not acked, budget left)."""
        return [e for e, ent in self.entries.items()
                if not ent.acked and not self._exhausted(ent)]

    def exhausted_epochs(self) -> List[int]:
        return [e for e, ent in self.entries.items()
                if self._exhausted(ent)]


class Collector:
    """Collector-side protocol state: exactly-once apply over an
    at-least-once channel.  ``applied`` is the set of (frag, epoch)
    cells whose payload has been merged into the system state;
    ``dedup`` remembers every (frag, epoch, seq) copy seen so exact
    duplicates are recognized (and still re-ACKed)."""

    def __init__(self):
        self.applied: Set[Tuple[int, int]] = set()
        self.dedup: Set[Tuple[int, int, int]] = set()
        self.n_rx = 0
        self.n_dup_rx = 0

    def clear(self) -> None:
        self.applied.clear()
        self.dedup.clear()


class DurableExportPlane:
    """At-least-once collection wrapper around a ``DiSketchSystem``.

    Parameters
    ----------
    system : DiSketchSystem
        Loop backend (per-epoch or window replay) or fleet backend in
        *window mode* (``Replayer.run(plane, window=E)``).  Fleet
        runners configured with ``parity_groups`` are rejected.
    channel, ack_channel : LossyChannel
        Data and ACK paths (default: lossless).
    max_retries, backoff0, backoff_max :
        Switch-side retransmission policy (see ``SwitchExporter``).
    ckpt_dir : str, optional
        Enables collector durability (``checkpoint``/``crash``).
    ckpt_every : int
        Auto-checkpoint every N protocol rounds (0 = manual only).
    steps_per_dispatch : int
        Protocol rounds to run after each ``run_epoch``/``run_window``
        (0 = advance time explicitly via ``step``/``drain``).
    """

    def __init__(self, system, channel: Optional[LossyChannel] = None,
                 ack_channel: Optional[LossyChannel] = None, *,
                 max_retries: int = 8, backoff0: int = 1,
                 backoff_max: int = 8,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 ckpt_keep: int = 3, steps_per_dispatch: int = 0):
        fleet = getattr(system, "fleet", None)
        if fleet is not None and fleet.parity_groups is not None:
            raise ValueError(
                "DurableExportPlane and parity_groups are mutually "
                "exclusive: parity recovery XORs the current window rows, "
                "which pending-export zeroing would corrupt")
        self.system = system
        self.channel = channel if channel is not None else LossyChannel()
        self.ack_channel = (ack_channel if ack_channel is not None
                            else LossyChannel())
        self.exporters: Dict[int, SwitchExporter] = {
            sw: SwitchExporter(sw, max_retries=max_retries,
                               backoff0=backoff0, backoff_max=backoff_max)
            for sw in system.fragments}
        self.collector = Collector()
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = int(ckpt_every)
        self.ckpt_keep = int(ckpt_keep)
        self.steps_per_dispatch = int(steps_per_dispatch)
        self.now = 0
        self._ckpt_step = 0
        self.n_crashes = 0
        self.last_observability: Optional[dict] = None

    # -- system duck-typing ------------------------------------------------

    @property
    def fleet(self):
        return self.system.fleet

    @property
    def fragments(self):
        return self.system.fragments

    @property
    def records(self):
        return self.system.records

    @property
    def kind(self):
        return self.system.kind

    def run_epoch(self, epoch: int, streams, packet=None, events=None
                  ) -> None:
        if self.system.backend == "fleet":
            raise ValueError(
                "the export plane drives the fleet backend in window "
                "mode only (Replayer.run(plane, window=E)); per-epoch "
                "fleet dispatches retain no patchable window")
        self.system.run_epoch(epoch, streams, events=events)
        self._stage_epoch(epoch)
        for _ in range(self.steps_per_dispatch):
            self.step()

    def run_window(self, epoch0: int, streams_list, packets=None,
                   events_by_epoch=None) -> None:
        self.system.run_window(epoch0, streams_list, packets=packets,
                               events_by_epoch=events_by_epoch)
        for e in range(epoch0, epoch0 + len(streams_list)):
            self._stage_epoch(e)
        for _ in range(self.steps_per_dispatch):
            self.step()

    # -- staging / apply ---------------------------------------------------

    def _stage_epoch(self, epoch: int) -> None:
        """Hold the epoch's freshly sketched cells back from the system
        until their export messages arrive."""
        fleet = self.system.fleet
        if fleet is not None:
            live = fleet.frag_live(epoch)
            staged = []
            for i, sw in enumerate(fleet.frag_order):
                if live is not None and not live[i]:
                    continue        # dead/lost cell: nothing to export
                self.exporters[sw].stage(
                    epoch, fleet.cell_counters(epoch, sw), self.now)
                staged.append(sw)
            if staged:
                fleet.mark_unexported(epoch, staged)
            return
        recs = self.system.records.get(epoch, {})
        for sw in list(recs):
            rec = recs.pop(sw)
            self.exporters[sw].stage(
                epoch, np.asarray(rec.counters).astype(np.int32), self.now)

    def _apply(self, sw: int, epoch: int, payload: np.ndarray) -> None:
        """Merge one delivered cell into the system state (idempotent at
        the caller: ``Collector.applied`` gates re-application)."""
        fleet = self.system.fleet
        if fleet is not None:
            fleet.deliver_cell(epoch, sw, payload)
            return
        from ..core.fragment import EpochRecords

        cfg = self.system.fragments[sw]
        counters = np.asarray(payload).astype(np.int64)
        n = int(counters.shape[-2])
        self.system.records.setdefault(epoch, {})[sw] = EpochRecords(
            cfg.frag_id, epoch, n, counters, cfg.kind, cfg.mitigation,
            cfg.base_seed)

    def _unapply(self, sw: int, epoch: int) -> None:
        """Re-mask one applied cell (collector crash lost it)."""
        fleet = self.system.fleet
        if fleet is not None:
            fleet.mark_unexported(epoch, [sw])
        else:
            self.system.records.get(epoch, {}).pop(sw, None)

    # -- protocol rounds ---------------------------------------------------

    def step(self) -> None:
        """One protocol round: advance time, retransmit due entries,
        deliver + apply + ACK data messages, deliver ACKs, and take the
        cadence checkpoint if due."""
        self.now += 1
        for sw in sorted(self.exporters):
            self.exporters[sw].tick(self.now, self.channel)
        for msg in self.channel.deliver(self.now):
            self._collect(msg)
        for ack in self.ack_channel.deliver(self.now):
            self.exporters[ack.frag].on_ack(ack.epoch)
        if (self.ckpt_dir is not None and self.ckpt_every > 0
                and self.now % self.ckpt_every == 0):
            self.checkpoint()

    def _collect(self, msg: ExportMsg) -> None:
        c = self.collector
        c.n_rx += 1
        key3 = (msg.frag, msg.epoch, msg.seq)
        if key3 in c.dedup:
            c.n_dup_rx += 1
        else:
            c.dedup.add(key3)
            cell = (msg.frag, msg.epoch)
            if cell not in c.applied:
                self._apply(msg.frag, msg.epoch, msg.payload)
                c.applied.add(cell)
        # always (re-)ACK — the previous ACK may have been lost
        self.ack_channel.send(AckMsg(msg.frag, msg.epoch, msg.seq),
                              self.now)

    def _quiescent(self) -> bool:
        if self.channel.pending() or self.ack_channel.pending():
            return False
        return not any(exp.unfinished() for exp in self.exporters.values())

    def drain(self, max_rounds: int = 10_000) -> int:
        """Run protocol rounds until every staged cell is ACKed or
        exhausted and both channels are empty.  Returns the final round;
        raises if the plane fails to quiesce (a hung retry loop is a
        bug, not a steady state)."""
        for _ in range(max_rounds):
            if self._quiescent():
                return self.now
            self.step()
        stuck = {sw: exp.unfinished()
                 for sw, exp in self.exporters.items() if exp.unfinished()}
        raise RuntimeError(
            f"export plane failed to drain within {max_rounds} rounds "
            f"(channel={self.channel.stats()}, unfinished={stuck})")

    # -- loss / staleness accounting --------------------------------------

    def lost_cells(self) -> Set[Tuple[int, int]]:
        """{(switch, epoch)} whose retry budget exhausted without the
        payload ever reaching the collector — permanently masked
        (blind-epoch extrapolation), never silently truncated."""
        out = set()
        for sw, exp in self.exporters.items():
            for e in exp.exhausted_epochs():
                if (sw, e) not in self.collector.applied:
                    out.add((sw, e))
        return out

    def pending_cells(self) -> Set[Tuple[int, int]]:
        """{(switch, epoch)} staged but not yet ACKed nor exhausted —
        still masked, still being retried."""
        return {(sw, e) for sw, exp in self.exporters.items()
                for e in exp.unfinished()}

    def observability(self, epochs: Sequence[int]) -> dict:
        """Staleness/observability accounting for a query window: which
        cells are genuine observations right now, which are in flight,
        which are permanently lost, and the blind-epoch extrapolation
        scale masked queries will apply."""
        epochs = list(epochs)
        sys_obs = self.system.observability(epochs)
        eset = set(epochs)
        out = dict(sys_obs)
        out["pending"] = sorted((sw, e) for sw, e in self.pending_cells()
                                if e in eset)
        out["lost"] = sorted((sw, e) for sw, e in self.lost_cells()
                             if e in eset)
        return out

    def query_flows(self, keys, paths, epochs, **kw):
        self.last_observability = self.observability(epochs)
        return self.system.query_flows(keys, paths, epochs, **kw)

    def query_entropy(self, keys, paths, epochs, total, **kw):
        self.last_observability = self.observability(epochs)
        return self.system.query_entropy(keys, paths, epochs, total, **kw)

    # -- durability --------------------------------------------------------

    def _payload_of(self, sw: int, epoch: int) -> np.ndarray:
        """Re-extract an applied cell's exact payload from the system
        (bit-identical to the delivered message body)."""
        fleet = self.system.fleet
        if fleet is not None:
            return fleet.cell_counters(epoch, sw)
        return np.asarray(
            self.system.records[epoch][sw].counters).astype(np.int32)

    def checkpoint(self) -> int:
        """Atomically persist the collector: every applied cell's
        counters + the protocol state (applied, dedup).  A committed
        checkpoint is the release watermark — switches drop retained
        payloads for the cells it contains."""
        if self.ckpt_dir is None:
            raise ValueError("no ckpt_dir configured")
        from ..ckpt.checkpoint import save_checkpoint

        applied = sorted(self.collector.applied)
        tree = [self._payload_of(sw, e) for sw, e in applied]
        extra = {"applied": [[int(sw), int(e)] for sw, e in applied],
                 "dedup": sorted([int(f), int(e), int(s)]
                                 for f, e, s in self.collector.dedup),
                 "now": int(self.now)}
        self._ckpt_step += 1
        save_checkpoint(self.ckpt_dir, self._ckpt_step, tree,
                        keep=self.ckpt_keep, extra=extra)
        for sw, e in applied:
            self.exporters[sw].release(e)
        return self._ckpt_step

    def _restore_latest(self):
        """Newest restorable committed checkpoint (walking past torn
        trailing steps), as (payloads, step, extra) or (None, None,
        None).  ``like_tree`` is rebuilt from each step's own manifest,
        so this wraps ``restore_checkpoint`` rather than needing the
        live tree shapes up front."""
        from ..ckpt.checkpoint import _committed_steps, restore_checkpoint

        for s in sorted(_committed_steps(self.ckpt_dir), reverse=True):
            path = os.path.join(self.ckpt_dir, f"step_{s:09d}")
            try:
                with open(os.path.join(path, "manifest.json")) as f:
                    man = json.load(f)
                like = [np.zeros(tuple(m["shape"]), np.dtype(m["dtype"]))
                        for m in man["leaves"]]
                tree, step, extra = restore_checkpoint(
                    self.ckpt_dir, like, step=s)
                return list(tree), step, extra
            except (OSError, ValueError, KeyError,
                    json.JSONDecodeError):
                continue
        return None, None, None

    def crash(self) -> dict:
        """Scripted collector crash + recovery.

        Drops every in-flight message and all collector state newer
        than the last committed checkpoint, restores that checkpoint
        (re-applying its payloads through the normal delivery path),
        then runs the recovery beacon: every switch re-stages the
        retained cells the restored collector lacks (fresh budget,
        covering ACKed-after-checkpoint deliveries) and treats the rest
        as re-ACKed.  Draining afterwards converges to a state
        bit-identical to a crash-free run.
        """
        self.n_crashes += 1
        lost_inflight = self.channel.clear() + self.ack_channel.clear()
        dropped = sorted(self.collector.applied)
        for sw, e in dropped:
            self._unapply(sw, e)
        self.collector.clear()
        restored_step = None
        if self.ckpt_dir is not None:
            tree, step, extra = self._restore_latest()
            if step is not None:
                for (sw, e), payload in zip(extra["applied"], tree):
                    self._apply(int(sw), int(e), np.asarray(payload))
                    self.collector.applied.add((int(sw), int(e)))
                self.collector.dedup = {(int(f), int(e), int(q))
                                        for f, e, q in extra["dedup"]}
                restored_step = step
        restaged = []
        for sw in sorted(self.exporters):
            restaged.extend(
                (sw, e) for e in self.exporters[sw].resync(
                    self.collector.applied, self.now))
        return {"restored_step": restored_step,
                "lost_inflight": lost_inflight,
                "dropped_cells": len(dropped),
                "restored_cells": len(self.collector.applied),
                "restaged": sorted(restaged)}

    # -- stats -------------------------------------------------------------

    def stats(self) -> dict:
        return {
            "now": self.now,
            "n_tx": sum(exp.n_tx for exp in self.exporters.values()),
            "n_rx": self.collector.n_rx,
            "n_dup_rx": self.collector.n_dup_rx,
            "n_applied": len(self.collector.applied),
            "n_pending": len(self.pending_cells()),
            "n_lost": len(self.lost_cells()),
            "n_crashes": self.n_crashes,
            "channel": self.channel.stats(),
            "ack_channel": self.ack_channel.stats(),
        }
