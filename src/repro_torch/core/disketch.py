"""DiSketch system orchestration: fragments + control loop + query plane
(port of ``repro/core/disketch.py``).

Per-switch single-row fragments sized to each switch's residual memory,
the §4.2 subepoch-count control loop run per epoch (``run_epoch``) or per
window (``run_window``), and composite queries: on the device next to the
resident window counters, or over the exported records (the record plane,
``core.query``).

``DiscoSystem`` is the DISCO baseline [17]: the same per-row
disaggregation without subepoching or equalization.
``AggregatedSystem`` is the traditional baseline: a full (depth x width)
sketch on each core switch (``core.sketches``).

Not ported yet: churn events and the failure policies beyond "every
fragment live", and device meshes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import equalize, query, sketches
from . import hashing as H
from .fragment import EpochRecords, FragmentConfig, process_epoch


def _g_entropy(x: torch.Tensor) -> torch.Tensor:
    """The entropy G-function of the device G-sum, ``x log2 max(x, 1)``."""
    return x * torch.log2(torch.clamp_min(x, 1.0))


@dataclass
class SwitchStream:
    """Packets traversing one switch during one epoch."""
    keys: np.ndarray         # uint32 flow ids
    values: np.ndarray       # int64 increments (1 per packet for counts)
    ts: np.ndarray           # int64 timestamps
    single_hop: Optional[np.ndarray] = None  # bool, §4.4


class DiSketchSystem:
    """The paper's system: spatiotemporally disaggregated sketching.

    ``backend`` selects the epoch execution engine:
      * ``"fleet"`` (default) — the CUDA kernels update every fragment of
        an epoch (``run_epoch``) or of an epoch window (``run_window``) in
        a few launches (``core.fleet.FleetEpochRunner``), bit-identical to
        the reference for cs, cms and UnivMon, with or without §4.4
        mitigation.  ``device`` (default ``cuda``; ``"cpu"`` runs the
        kernels' plain versions) holds the counters; ``fleet_kwargs`` go
        to the runner (``blk``, ``layout``, ``keep_stacked``).
      * ``"loop"`` — the host numpy per-switch simulator, one
        ``process_epoch`` per switch; it refuses ``device`` and
        ``fleet_kwargs`` rather than ignore them.
    The reference defaults to ``"loop"``; the port runs on the card unless
    asked otherwise.
    """

    name = "disketch"
    subepoching = True

    def __init__(self, switch_memories: Dict[int, int], kind: str,
                 rho_target: float, log2_te: int, counter_bytes: int = 4,
                 mitigation: bool = False, n_levels: int = 16, seed: int = 0,
                 backend: str = "fleet",
                 fleet_kwargs: Optional[Dict] = None,
                 mesh=None, device=None):
        if backend not in ("loop", "fleet"):
            raise ValueError(f"unknown backend {backend!r}")
        if mesh is not None:
            raise NotImplementedError("device meshes are not ported yet")
        if backend == "loop" and (device is not None or fleet_kwargs):
            raise ValueError("backend='loop' is the host numpy simulator: "
                             "it takes no device or fleet_kwargs")
        self.kind = kind
        self.rho_target = rho_target
        self.log2_te = log2_te
        self.fragments: Dict[int, FragmentConfig] = {
            sw: FragmentConfig(frag_id=sw, kind=kind, memory_bytes=mem,
                               counter_bytes=counter_bytes,
                               mitigation=mitigation, n_levels=n_levels,
                               base_seed=seed)
            for sw, mem in switch_memories.items()
        }
        # rho_-1 undefined: start every fragment at n_0 = 1 (§4.2).
        self.ns: Dict[int, int] = {sw: 1 for sw in switch_memories}
        self.records: Dict[int, Dict[int, EpochRecords]] = {}  # epoch -> sw
        self.peb_log: List[Dict[int, float]] = []
        self.n_log: List[Dict[int, int]] = []
        self.backend = backend
        self.fleet = None
        if backend == "fleet":
            from .fleet import FleetEpochRunner

            self.fleet = FleetEpochRunner(self.fragments, log2_te,
                                          device=device,
                                          **dict(fleet_kwargs or {}))

    def _control_ns(self) -> Dict[int, int]:
        """The subepoch counts the next dispatch runs at."""
        if self.subepoching:
            return dict(self.ns)
        return {sw: 1 for sw in self.fragments}

    def _observe(self, epoch: int, recs, pebs: Dict[int, float]) -> None:
        """Keep an epoch's records and PEBs and apply Eq. 6."""
        self.records[epoch] = recs
        self.peb_log.append(pebs)
        if self.subepoching:
            for sw, peb in pebs.items():
                self.ns[sw] = equalize.next_n(self.ns[sw], peb,
                                              self.rho_target)
        self.n_log.append(dict(self.ns))

    def run_epoch(self, epoch: int, streams: Dict[int, SwitchStream],
                  packet=None, events: Optional[Sequence] = None) -> None:
        """Process one epoch, then apply Eq. 6 to its PEBs.  ``packet`` (a
        prepacked ``FleetPacket``, e.g. from ``Replayer.epoch_packet``)
        lets the fleet backend skip re-packing ``streams``; the loop
        backend ignores it."""
        if events:
            raise NotImplementedError("churn events are not ported yet")
        if self.backend == "fleet":
            recs, pebs = self.fleet.run_epoch(epoch, self._control_ns(),
                                              streams, packet=packet)
        else:
            recs, pebs = self._run_epoch_loop(epoch, streams)
        self._observe(epoch, recs, pebs)

    def _run_epoch_loop(self, epoch: int, streams: Dict[int, SwitchStream],
                        ) -> Tuple[Dict[int, EpochRecords],
                                   Dict[int, float]]:
        epoch_start = epoch << self.log2_te
        recs: Dict[int, EpochRecords] = {}
        pebs: Dict[int, float] = {}
        for sw, cfg in self.fragments.items():
            st = streams.get(sw)
            n = self.ns[sw] if self.subepoching else 1
            if st is None or len(st.keys) == 0:
                st = SwitchStream(np.zeros(0, np.uint32),
                                  np.zeros(0, np.int64),
                                  np.zeros(0, np.int64))
            rec = process_epoch(cfg, epoch, n, st.keys, st.values, st.ts,
                                epoch_start, self.log2_te,
                                single_hop=st.single_hop)
            recs[sw] = rec
            pebs[sw] = equalize.peb_epoch(rec)
        return recs, pebs

    def run_window(self, epoch0: int,
                   streams_list: Sequence[Dict[int, SwitchStream]],
                   packets: Optional[Sequence] = None,
                   events_by_epoch: Optional[Sequence[Sequence]] = None,
                   ) -> None:
        """Process ``len(streams_list)`` consecutive epochs from ``epoch0``
        in one fleet super-dispatch, ``ns`` frozen for the window.  At the
        window boundary the per-epoch PEBs are replayed through Eq. 6 in
        order, so the control reacts to every epoch with window latency.
        ``packets`` (prepacked ``FleetPacket``s, e.g. from
        ``Replayer.epoch_packet``) skip re-packing.  The loop backend
        processes the epochs one by one (exact per-epoch control)."""
        if events_by_epoch is not None and any(events_by_epoch):
            raise NotImplementedError("churn events are not ported yet")
        if self.backend != "fleet":
            for e, streams in enumerate(streams_list):
                self.run_epoch(epoch0 + e, streams)
            return
        from .fleet import pack_streams

        if packets is None:
            packets = [pack_streams(st, self.fleet.frag_order)
                       for st in streams_list]
        recs_list, pebs_list = self.fleet.run_window(
            epoch0, self._control_ns(), packets)
        for e, (recs, pebs) in enumerate(zip(recs_list, pebs_list)):
            self._observe(epoch0 + e, recs, pebs)

    def _records_for(self, path: Sequence[int], epochs: Sequence[int],
                     ) -> List[List[EpochRecords]]:
        """The on-path records of every epoch (§4.3 Step 1).  A window
        query over an unprocessed epoch fails loudly: a dropped epoch
        would truncate O_Q = Sum(O)."""
        missing = [e for e in epochs if e not in self.records]
        if missing:
            raise KeyError(f"epochs {missing} have no records "
                           "(not processed); run them before querying")
        return [[self.records[e][sw] for sw in path
                 if sw in self.records[e]] for e in epochs]

    def query_flows(self, keys: np.ndarray, paths: Sequence[Tuple[int, ...]],
                    epochs: Sequence[int], merge: str = "subepoch",
                    failures: str = "mask") -> np.ndarray:
        """Window frequency estimates for flows with per-flow paths, per
        path group (§4.3 Step 1: the group's on-path fragments only).

        With ``merge="fragment"`` on the fleet backend, windows whose
        counters are still on the device are answered there and only the
        per-group ``(K,)`` estimates come back.  Everything else — the
        default subepoch merge (Fig. 9, §4.3 Step 2), the loop backend,
        per-epoch runs, windows already copied to the host — goes through
        the record plane (``query.query_window``) on the exported records.
        UnivMon frequencies come from level 0, and the §4.4
        second-subepoch average applies to single-hop groups, on both
        planes.  ``failures`` is accepted for the reference's signature;
        no churn is ported, so every policy reads every fragment.
        """
        if failures not in ("oblivious", "mask", "recover"):
            raise ValueError(f"unknown failure policy {failures!r}")
        keys = np.asarray(keys, dtype=np.uint32)
        out = np.zeros(len(keys))
        by_path = query.path_groups(paths)
        device_ok = (merge == "fragment" and self.fleet is not None
                     and self.fleet.has_device_window(epochs))
        level = 0 if self.kind == "um" else None
        for path, idxs in by_path.items():
            if device_ok:
                out[idxs] = self.fleet.window_query(
                    epochs, keys[idxs], path=path, level=0,
                    single_hop=len(path) == 1, failures=failures)
                continue
            recs = self._records_for(path, epochs)
            n_obs, scale = query.window_observability(recs)
            if not n_obs:
                raise ValueError(
                    f"no epoch in {list(epochs)} has a fragment on path "
                    f"{path}; the window is unobservable")
            sh = np.full(len(idxs), len(path) == 1)
            out[idxs] = query.query_window(
                recs, keys[idxs], self.kind, single_hop=sh, level=level,
                merge=merge) * scale
        return out

    def query_entropy(self, keys: np.ndarray,
                      paths: Sequence[Tuple[int, ...]],
                      epochs: Sequence[int], total: float,
                      n_levels: int = 16, level_seed: int = 7777,
                      k_heavy: int = 1024,
                      merge: str = "subepoch",
                      failures: str = "mask") -> float:
        """Network-wide empirical entropy (bits) from the UnivMon level
        stack, over the candidate ``keys`` with their paths.

        With ``merge="fragment"`` on the fleet backend, where every
        queried epoch's window is still on the device and ``n_levels`` /
        ``level_seed`` are the fleet's, each path group's all-levels
        estimates come from one batched gather/merge
        (``FleetEpochRunner.um_level_window_query``) and the top-down
        G-sum runs on the device (``um_gsum_device``): only the per-level
        estimates and one scalar cross to the host.  Everything else (the
        default subepoch merge, the loop backend, host windows) goes
        through the record plane (``query.um_entropy_window``).
        ``failures`` follows ``query_flows``.
        """
        if self.kind != "um":
            raise ValueError(f"query_entropy needs a UnivMon system, this "
                             f"one is {self.kind!r}")
        if failures not in ("oblivious", "mask", "recover"):
            raise ValueError(f"unknown failure policy {failures!r}")
        by_path = query.path_groups(paths)
        keys = np.asarray(keys, dtype=np.uint32)
        device_ok = (merge == "fragment" and self.fleet is not None
                     and self.fleet.has_device_window(epochs)
                     and n_levels == self.fleet.n_levels
                     and level_seed == self.fleet.level_seed)
        if device_ok:
            from ..kernels.sketch_query import um_gsum_device

            ests, lvls = [], []
            for path, idxs in by_path.items():
                ks = keys[idxs]
                ests.append(self.fleet.um_level_window_query(
                    epochs, ks, path=path, failures=failures))
                lvls.append(H.level_of(ks, level_seed, n_levels))
            if not ests:
                return 0.0 if total <= 0 else float(np.log2(total))
            s = um_gsum_device(np.concatenate(ests, axis=1),
                               np.concatenate(lvls), _g_entropy,
                               k_heavy=k_heavy, device=self.fleet.device)
            if total <= 0:
                return 0.0
            return float(np.log2(total) - s / total)
        recs, keysets = [], []
        for path, idxs in by_path.items():
            recs.append(self._records_for(path, epochs))
            keysets.append(keys[idxs])
        return query.um_entropy_window(recs, keysets, n_levels, level_seed,
                                       total, k_heavy=k_heavy, merge=merge)


def calibrate_rho_target(switch_memories: Dict[int, int], kind: str,
                         streams: Dict[int, SwitchStream], log2_te: int,
                         quantile: float = 0.5, **kw) -> float:
    """Select a network-wide rho_target from a probe epoch (§4.2/§7).

    Runs one epoch with n = 1 everywhere and returns a quantile of the
    observed per-fragment PEBs (floored at 1): the target is what
    well-provisioned fragments already deliver; worse fragments subsample
    time (raise n) until they match it.  ``kw`` goes to the probe
    ``DiSketchSystem`` (``backend``, ``device``, ...).
    """
    probe = DiSketchSystem(switch_memories, kind, rho_target=float("inf"),
                           log2_te=log2_te, **kw)
    probe.run_epoch(0, streams)
    pebs = [p for p in probe.peb_log[0].values() if p > 0]
    if not pebs:
        return 1.0
    return float(max(np.quantile(pebs, quantile), 1.0))


class DiscoSystem(DiSketchSystem):
    """DISCO [17]: per-row disaggregation, no subepoching / equalization."""

    name = "disco"
    subepoching = False


class AggregatedSystem:
    """Traditional deployment: a full sketch on each core switch (§6),
    its int64 counters on ``device`` (default ``cuda``)."""

    name = "aggregated"

    def __init__(self, core_memories: Dict[int, int], kind: str,
                 depth: int = 4, counter_bytes: int = 4, n_levels: int = 16,
                 seed: int = 0, device=None):
        self.kind = kind
        self.depth = depth
        self.n_levels = n_levels
        self.device = resolve_device(device)
        self.specs: Dict[int, object] = {}
        self.counters: Dict[int, Dict[int, torch.Tensor]] = {}  # epoch -> sw
        for sw, mem in core_memories.items():
            w = max(mem // (counter_bytes * depth), 4)
            if kind == "um":
                w = max(w // n_levels, 4)
                self.specs[sw] = sketches.UnivMonSpec(depth, w, n_levels,
                                                      seed=seed + sw)
            else:
                self.specs[sw] = sketches.SketchSpec(kind, depth, w,
                                                     seed=seed + sw)

    def run_epoch(self, epoch: int, streams: Dict[int, SwitchStream],
                  events: Optional[Sequence] = None) -> None:
        if events:
            raise ValueError(
                "AggregatedSystem models no churn: a monolithic core sketch "
                "has no reclaimable per-switch fragments; failure schedules "
                "apply to disaggregated systems only")
        recs = {}
        for sw, spec in self.specs.items():
            st = streams.get(sw)
            if self.kind == "um":
                c = sketches.um_make_counters(spec, self.device)
                if st is not None and len(st.keys):
                    c = sketches.um_update(spec, c, st.keys, st.values)
            else:
                c = sketches.make_counters(spec, self.device)
                if st is not None and len(st.keys):
                    c = sketches.update(spec, c, st.keys, st.values)
            recs[sw] = c
        self.counters[epoch] = recs

    def query_flows(self, keys: np.ndarray, core_switch: Sequence[int],
                    epochs: Sequence[int]) -> np.ndarray:
        """Query each flow at the (single) core switch on its path; a
        window over an unprocessed epoch raises ``KeyError``."""
        keys = np.asarray(keys, dtype=np.uint32)
        missing = [e for e in epochs if e not in self.counters]
        if missing:
            raise KeyError(f"epochs {missing} have no counters "
                           "(not processed); run them before querying")
        out = np.zeros(len(keys))
        by_sw: Dict[int, List[int]] = {}
        for i, sw in enumerate(core_switch):
            by_sw.setdefault(int(sw), []).append(i)
        for sw, idxs in by_sw.items():
            idxs = np.asarray(idxs)
            spec = self.specs[sw]
            for e in epochs:
                c = self.counters[e][sw]
                if self.kind == "um":
                    out[idxs] += sketches.um_query_freq(spec, c, keys[idxs])
                else:
                    out[idxs] += sketches.query(spec, c, keys[idxs])
        return out
