"""DiSketch system orchestration: fragments + control loop + query plane
(port of ``repro/core/disketch.py``, fleet window path).

Per-switch single-row fragments sized to each switch's residual memory,
an epoch-window super-dispatch on the device (``core.fleet``), the §4.2
subepoch-count control loop, and composite queries answered next to the
resident counters.

Not ported yet: the per-switch ``loop`` backend, per-epoch dispatch,
churn events, the subepoch merge of the record plane and the UnivMon
all-levels queries (``query_entropy``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import equalize
from .fragment import EpochRecords, FragmentConfig


@dataclass
class SwitchStream:
    """Packets traversing one switch during one epoch."""
    keys: np.ndarray         # uint32 flow ids
    values: np.ndarray       # int64 increments (1 per packet for counts)
    ts: np.ndarray           # int64 timestamps
    single_hop: Optional[np.ndarray] = None  # bool, §4.4


class DiSketchSystem:
    """The paper's system: spatiotemporally disaggregated sketching.

    ``backend="fleet"`` updates every fragment of an epoch window with the
    batched CUDA kernel (``core.fleet.FleetEpochRunner``), bit-identical to
    the reference for cs, cms and UnivMon, with or without §4.4
    mitigation.  ``device`` (default ``cuda``) holds the window stacks;
    ``fleet_kwargs`` go to the runner.  The reference's default ``"loop"``
    backend is not ported yet and raises.
    """

    name = "disketch"

    def __init__(self, switch_memories: Dict[int, int], kind: str,
                 rho_target: float, log2_te: int, counter_bytes: int = 4,
                 mitigation: bool = False, n_levels: int = 16, seed: int = 0,
                 backend: str = "loop",
                 fleet_kwargs: Optional[Dict] = None,
                 mesh=None, device=None):
        if backend == "loop":
            raise NotImplementedError(
                "the per-switch loop backend is not ported yet; use "
                "backend='fleet'")
        if backend != "fleet":
            raise ValueError(f"unknown backend {backend!r}")
        if mesh is not None:
            raise NotImplementedError("device meshes are not ported yet")
        from .fleet import FleetEpochRunner

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
        self.fleet = FleetEpochRunner(self.fragments, log2_te, device=device,
                                      **dict(fleet_kwargs or {}))

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
        ``Replayer.epoch_packet``) skip re-packing."""
        if events_by_epoch is not None and any(events_by_epoch):
            raise NotImplementedError("churn events are not ported yet")
        from .fleet import pack_streams

        if packets is None:
            packets = [pack_streams(st, self.fleet.frag_order)
                       for st in streams_list]
        recs_list, pebs_list = self.fleet.run_window(epoch0, dict(self.ns),
                                                     packets)
        for e, (recs, pebs) in enumerate(zip(recs_list, pebs_list)):
            self.records[epoch0 + e] = recs
            self.peb_log.append(pebs)
            for sw, peb in pebs.items():
                self.ns[sw] = equalize.next_n(self.ns[sw], peb,
                                              self.rho_target)
            self.n_log.append(dict(self.ns))

    def query_flows(self, keys: np.ndarray, paths: Sequence[Tuple[int, ...]],
                    epochs: Sequence[int], merge: str = "subepoch",
                    failures: str = "mask") -> np.ndarray:
        """Window frequency estimates for flows with per-flow paths, one
        batched fleet query per path group (§4.3 Step 1: the group's
        on-path fragments only).

        ``merge="fragment"`` is ported: resident windows are answered on
        the device and only the per-group ``(K,)`` estimates come back;
        windows already copied to the host take the numpy twin.  UnivMon
        frequencies come from level 0, and the §4.4 second-subepoch
        average applies to single-hop groups.  The record plane's
        ``merge="subepoch"`` (the reference's default) is not ported yet.
        ``failures`` is accepted for the reference's signature; no churn
        is ported, so every policy reads every fragment.
        """
        if merge != "fragment":
            raise NotImplementedError(
                f"merge={merge!r} (the record plane) is not ported yet; "
                "use merge='fragment'")
        keys = np.asarray(keys, dtype=np.uint32)
        out = np.zeros(len(keys))
        by_path: Dict[Tuple[int, ...], List[int]] = {}
        for i, p in enumerate(paths):
            by_path.setdefault(tuple(p), []).append(i)
        for path, idxs in by_path.items():
            idxs = np.asarray(idxs)
            out[idxs] = self.fleet.window_query(
                epochs, keys[idxs], path=path, level=0,
                single_hop=len(path) == 1, failures=failures)
        return out

    def query_entropy(self, *args, **kwargs) -> float:
        raise NotImplementedError(
            "UnivMon entropy (the all-levels query plane) is not ported yet")
