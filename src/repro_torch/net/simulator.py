"""Epoch-driven replay engine (port of ``repro/net/simulator.py``'s
``Replayer``): feeds per-switch packet streams to a system, one epoch or
one epoch window at a time.

For every switch it precomputes the packets whose path traverses it, split
by epoch (the split uses timestamps, so subepoch semantics are exact).
Failure schedules are not ported yet.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List

import numpy as np

from ..core.disketch import SwitchStream
from .traffic import Workload


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

    def run(self, system, window: int = 1) -> None:
        """Replay every epoch through ``system``.

        ``window=1`` (the default) runs the paper's per-epoch control:
        ``system.run_epoch`` epoch by epoch, fleet-backed systems getting
        the cached packed epoch (``epoch_packet``).  ``window=E`` on a
        fleet-backed system batches E consecutive epochs into one
        super-dispatch (``system.run_window``; ``ns`` frozen per window,
        the tail window may be shorter); systems without a fleet run
        epoch by epoch whatever the window.
        """
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        fleet = getattr(system, "fleet", None)
        if window > 1 and fleet is not None:
            order = fleet.frag_order
            for e0 in range(0, self.wl.n_epochs, window):
                eps = range(e0, min(e0 + window, self.wl.n_epochs))
                system.run_window(e0, [self._streams[e] for e in eps],
                                  packets=[self.epoch_packet(e, order)
                                           for e in eps])
            return
        for ep in range(self.wl.n_epochs):
            if fleet is not None:
                system.run_epoch(ep, self._streams[ep],
                                 packet=self.epoch_packet(
                                     ep, fleet.frag_order))
            else:
                system.run_epoch(ep, self._streams[ep])

    def epoch_stream(self, epoch: int) -> Dict[int, SwitchStream]:
        return self._streams[epoch]

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
