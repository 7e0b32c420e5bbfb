"""DiSketch system orchestration: fragments + control loop + query plane
(port of ``repro/core/disketch.py``).

Per-switch single-row fragments sized to each switch's residual memory,
the §4.2 subepoch-count control loop run per epoch (``run_epoch``) or per
window (``run_window``), or left to a versioned control plane over a lossy
channel (``control_external``, ``runtime.control``), and composite
queries: on the device next to the resident window counters, or over the
exported records (the record plane, ``core.query``).

Churn (§6): ``apply_event`` takes switch failures, recoveries and
resource resizes (``net.simulator.FailureSchedule``, ``ResourcePressure``)
into the control plane; dead switches stop counting, survivors are
re-equalized, and every query takes a ``failures`` policy ("mask",
"recover", "oblivious") on both planes.

``DiscoSystem`` is the DISCO baseline [17]: the same per-row
disaggregation without subepoching or equalization.
``AggregatedSystem`` is the traditional baseline: a full (depth x width)
sketch on each core switch (``core.sketches``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
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

    ``mesh`` (fleet backend only, in place of ``device``) shards the
    fragment fleet over the ``"switch"`` axis of a device mesh
    (``launch.mesh.make_switch_mesh``): updates dispatch shard-locally,
    each shard's row groups stay on its device, and queries copy only the
    gathered estimate slices to the merge device — bit-identical to the
    single-device fleet.
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
        if mesh is not None and backend != "fleet":
            raise ValueError(
                "mesh sharding requires backend='fleet' (the loop "
                "backend is per-switch host numpy)")
        if mesh is not None and device is not None:
            raise ValueError("pass mesh= or device=, not both: the mesh "
                             "names the devices")
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
        # -- churn state (a FailureSchedule drives it through apply_event) --
        # Switches whose sketch resource is reclaimed now.  A dead switch
        # keeps forwarding (disaggregation uses residual resources, §1) but
        # stops counting: value-0 packets on the fleet, skipped by the loop
        # backend, masked from the queries and held out of §4.2.
        self.dead: set = set()
        self._dead_at: Dict[int, frozenset] = {}   # epoch -> dead set
        # Resizes (shrinks and grows) arriving inside a window wait for the
        # next dispatch (widths are frozen per window); factors multiply.
        self._pending_resize: Dict[int, float] = {}
        # The width each switch had when its last PEB was observed: after a
        # resize that PEB is stale, and §6 re-equalization converges
        # against the width-scaled bound (``_reequalize_survivors``).
        self._peb_width: Dict[int, int] = {}
        # Re-equalizations the actual width clamped (intended vs applied),
        # surfaced by ``observability``.
        self.clamp_log: List[Dict] = []
        # External control (``runtime.control.VersionedControlPlane`` sets
        # it): the system stops applying Eq. 6 and §6 itself, so ``ns``
        # holds what the switches actually applied and the (possibly
        # lossy) control plane owns the intent.
        self.control_external = False
        # What the last query window could observe (``observability``).
        self.last_observability: Optional[Dict] = None
        self.backend = backend
        self.fleet = None
        if backend == "fleet":
            from .fleet import FleetEpochRunner

            kw = dict(fleet_kwargs or {})
            if mesh is not None:
                kw.setdefault("mesh", mesh)
            self.fleet = FleetEpochRunner(self.fragments, log2_te,
                                          device=device, **kw)

    def _control_ns(self) -> Dict[int, int]:
        """The subepoch counts the next dispatch runs at."""
        if self.subepoching:
            return dict(self.ns)
        return {sw: 1 for sw in self.fragments}

    def _observe(self, epoch: int, dead: frozenset, recs,
                 pebs: Dict[int, float]) -> None:
        """Keep an epoch's dead set, records and PEBs and apply Eq. 6
        (unless the control is external)."""
        if dead:
            self._dead_at[epoch] = dead
        else:
            self._dead_at.pop(epoch, None)
        self.records[epoch] = recs
        self.peb_log.append(pebs)
        for sw in pebs:
            self._peb_width[sw] = self.fragments[sw].width
        if self.subepoching and not self.control_external:
            for sw, peb in pebs.items():
                self.ns[sw] = equalize.next_n(self.ns[sw], peb,
                                              self.rho_target)
        self.n_log.append(dict(self.ns))

    # -- churn control plane -------------------------------------------------

    def apply_event(self, event, *, defer_resize: bool = False) -> None:
        """Apply one churn event to the control plane.

        ``event`` has ``.kind`` in {"fail", "recover", "shrink", "grow"},
        ``.switch`` and ``.factor`` (``net.simulator.FailureEvent``).
        "fail" reclaims the switch's sketch resource and re-equalizes the
        survivors (§6; not under external control); "recover" rejoins it
        as a fresh fragment at n_0 = 1 (its history went with the memory);
        "shrink"/"grow" multiply its memory by ``factor`` now, or at the
        next dispatch when ``defer_resize`` (widths are frozen inside a
        window).
        """
        sw = event.switch
        if sw not in self.fragments:
            raise KeyError(f"churn event for unknown switch {sw}")
        with obs.span("disketch.apply_event"):
            if event.kind == "fail":
                if sw not in self.dead:
                    self.dead.add(sw)
                    if not self.control_external:
                        before = dict(self.ns)
                        self._reequalize_survivors()
                        obs.add("reequalized", sum(
                            1 for s, n in before.items() if self.ns[s] != n))
            elif event.kind == "recover":
                if sw in self.dead:
                    self.dead.discard(sw)
                    self.ns[sw] = 1
            elif event.kind in ("shrink", "grow"):
                if defer_resize:
                    self._pending_resize[sw] = (
                        self._pending_resize.get(sw, 1.0) * event.factor)
                else:
                    self._apply_resize(sw, event.factor)
            else:
                raise ValueError(f"unknown churn event kind {event.kind!r}")

    def _last_pebs(self) -> Dict[int, float]:
        last: Dict[int, float] = {}
        for pebs in self.peb_log:
            last.update(pebs)
        return last

    def _reequalize_survivors(self) -> None:
        """§6: a death shifts no load (the switch keeps forwarding), so the
        survivors' last PEBs are the freshest signal: each survivor jumps
        to its converged Eq. 6 setting in one step.  Survivors inside the
        band, and switches never observed, keep their n, so an equalized
        fleet stays bit-identical after an off-path death.  A survivor
        resized since its last PEB converges against the width-scaled
        bound (Eq. 4 goes as ~1/width); the clamp goes to ``clamp_log``."""
        if not self.subepoching:
            return
        last = self._last_pebs()
        survivors = {sw: n for sw, n in self.ns.items() if sw not in self.dead}
        intended = equalize.reequalize(survivors, last, self.rho_target)
        applied = dict(intended)
        for sw, n0 in survivors.items():
            peb = last.get(sw)
            w_obs = self._peb_width.get(sw)
            w_now = self.fragments[sw].width
            if peb is None or peb <= 0 or w_obs is None or w_obs == w_now:
                continue
            applied[sw] = equalize.converge_n(
                n0, peb * (w_obs / w_now), self.rho_target)
            if applied[sw] != intended[sw]:
                self.clamp_log.append({
                    "switch": sw, "at_epoch": len(self.peb_log),
                    "n_intended": intended[sw], "n_applied": applied[sw],
                    "width_observed": w_obs, "width_actual": w_now})
        self.ns.update(applied)

    def _apply_resize(self, sw: int, factor: float) -> None:
        """Resize a fragment's memory now.  Resizing the columns scales the
        per-counter load (and the Eq. 4 bound) by ~w_old / w_new, so n
        converges against that prediction at once; the next observed epoch
        corrects it through Eq. 6.  Under external control the control
        plane makes that adjustment instead."""
        cfg = self.fragments[sw]
        new_mem = max(int(cfg.memory_bytes * factor), 4 * cfg.counter_bytes)
        w_old = cfg.width
        self.fragments[sw] = replace(cfg, memory_bytes=new_mem)
        if self.fleet is not None:
            self.fleet.refresh_widths()
        if (self.subepoching and not self.control_external
                and sw not in self.dead):
            last = self._last_pebs().get(sw)
            w_new = self.fragments[sw].width
            if last is not None and last > 0 and w_new != w_old:
                self.ns[sw] = equalize.converge_n(
                    self.ns[sw], last * (w_old / w_new), self.rho_target)

    def _apply_pending_resizes(self) -> None:
        for sw, factor in self._pending_resize.items():
            self._apply_resize(sw, factor)
        self._pending_resize.clear()

    # -- data plane ----------------------------------------------------------

    def run_epoch(self, epoch: int, streams: Dict[int, SwitchStream],
                  packet=None, events: Optional[Sequence] = None) -> None:
        """Process one epoch, then apply Eq. 6 to its PEBs.  ``packet`` (a
        prepacked ``FleetPacket``, e.g. from ``Replayer.epoch_packet``)
        lets the fleet backend skip re-packing ``streams``; the loop
        backend ignores it.  ``events`` are churn events taking effect at
        the epoch's start (resizes deferred by a window land first)."""
        self._apply_pending_resizes()
        for ev in (events or ()):
            self.apply_event(ev)
        dead = frozenset(self.dead)
        if self.backend == "fleet":
            recs, pebs = self.fleet.run_epoch(epoch, self._control_ns(),
                                              streams, packet=packet,
                                              dead=dead)
        else:
            recs, pebs = self._run_epoch_loop(epoch, streams)
        self._observe(epoch, dead, recs, pebs)

    def _run_epoch_loop(self, epoch: int, streams: Dict[int, SwitchStream],
                        ) -> Tuple[Dict[int, EpochRecords],
                                   Dict[int, float]]:
        epoch_start = epoch << self.log2_te
        recs: Dict[int, EpochRecords] = {}
        pebs: Dict[int, float] = {}
        for sw, cfg in self.fragments.items():
            if sw in self.dead:
                continue
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
        processes the epochs one by one (exact per-epoch control).

        ``events_by_epoch`` (one event sequence per window offset) injects
        churn.  Offset-0 events apply before ``ns`` is frozen; later ones
        apply during the window, their resizes deferred to the next
        dispatch (a "fail" re-equalizes ``ns`` at once, for the next
        window).  A "fail" at offset e masks the switch from epoch e on
        and marks its earlier epochs of the window *lost*: the reclaimed
        memory held them, so they are zeroed unless an XOR-parity group
        (``fleet_kwargs={"parity_groups": ...}``) can rebuild them.
        """
        with obs.span("disketch.run_window"):
            if self.backend != "fleet":
                for e, streams in enumerate(streams_list):
                    self.run_epoch(
                        epoch0 + e, streams,
                        events=events_by_epoch[e] if events_by_epoch else None)
                return
            from .fleet import pack_streams

            e_count = len(streams_list)
            if (events_by_epoch is not None
                    and len(events_by_epoch) != e_count):
                raise ValueError("events_by_epoch must have one entry per "
                                 f"epoch ({len(events_by_epoch)} != "
                                 f"{e_count})")
            self._apply_pending_resizes()
            for ev in (events_by_epoch[0] if events_by_epoch else ()):
                self.apply_event(ev)
            ns = self._control_ns()
            dead_sets = [frozenset(self.dead)]
            fail_pts: List[Tuple[int, int]] = []
            for e in range(1, e_count):
                for ev in (events_by_epoch[e] if events_by_epoch else ()):
                    if ev.kind == "fail" and ev.switch not in self.dead:
                        fail_pts.append((e, ev.switch))
                    self.apply_event(ev, defer_resize=True)
                dead_sets.append(frozenset(self.dead))
            lost_sets: List[set] = [set() for _ in range(e_count)]
            for e, sw in fail_pts:
                for e2 in range(e):
                    if sw not in dead_sets[e2]:
                        lost_sets[e2].add(sw)
            if packets is None:
                packets = [pack_streams(st, self.fleet.frag_order)
                           for st in streams_list]
            recs_list, pebs_list = self.fleet.run_window(
                epoch0, ns, packets, dead_by_epoch=dead_sets,
                lost_by_epoch=lost_sets)
            with obs.span("disketch.observe"):
                for e, (recs, pebs) in enumerate(zip(recs_list, pebs_list)):
                    self._observe(epoch0 + e, dead_sets[e], recs, pebs)

    # -- query plane ---------------------------------------------------------

    def observability(self, epochs: Sequence[int]) -> Dict:
        """What a query window can observe now: per epoch, how many
        fragment cells are genuine observations (not dead, not lost), the
        blind-epoch extrapolation scale (E / E_observable) of a masked
        query, and the §6 re-equalizations the width clamped.  Every query
        entry point stamps it on ``last_observability``."""
        epochs = list(epochs)
        n_frags = len(self.fragments)
        # a window's records list every fragment, a per-epoch run's only
        # those alive then; _valid drops the dead and lost ones
        per_epoch = {e: sum(1 for sw in self.records.get(e, {})
                            if self._valid(sw, e)) for e in epochs}
        obs = sum(1 for e in epochs if per_epoch[e])
        scale = len(epochs) / obs if obs else float("inf")
        return {"epochs": len(epochs), "observable_epochs": obs,
                "scale": scale,
                "observable_cells": sum(per_epoch.values()),
                "total_cells": n_frags * len(epochs),
                "per_epoch": per_epoch,
                "config_clamps": list(self.clamp_log)}

    def _valid(self, sw: int, epoch: int) -> bool:
        """Is (switch, epoch) a genuine observation?  Dead and lost cells
        are not; parity-recovered cells are again."""
        if self.fleet is not None:
            return self.fleet.is_live(sw, epoch)
        return sw not in self._dead_at.get(epoch, frozenset())

    def _records_for(self, path: Sequence[int], epochs: Sequence[int],
                     failures: str = "mask") -> List[List[EpochRecords]]:
        """The on-path records of every epoch (§4.3 Step 1), without the
        dead and lost cells unless ``failures="oblivious"``.  A window
        query over an unprocessed epoch fails loudly: a dropped epoch
        would truncate O_Q = Sum(O)."""
        missing = [e for e in epochs if e not in self.records]
        if missing:
            raise KeyError(f"epochs {missing} have no records "
                           "(not processed); run them before querying")
        if failures == "oblivious":
            return [[self.records[e][sw] for sw in path
                     if sw in self.records[e]] for e in epochs]
        return [[self.records[e][sw] for sw in path
                 if sw in self.records[e] and self._valid(sw, e)]
                for e in epochs]

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
        planes.

        ``failures`` is the churn policy, on both planes:
          * ``"mask"`` (default) drops the dead and lost cells from the
            merge; an epoch with no live on-path fragment is *blind*, and
            the window estimate is extrapolated by E / E_observable.  A
            path with no observable epoch raises ``ValueError``.
          * ``"recover"`` first rebuilds every parity-recoverable lost
            cell (``FleetEpochRunner.recover``), then masks.
          * ``"oblivious"`` pretends nothing failed: the zeroed rows enter
            the min/median, and nothing is extrapolated.
        """
        with obs.span("disketch.query_flows"):
            if failures not in ("oblivious", "mask", "recover"):
                raise ValueError(f"unknown failure policy {failures!r}")
            self.last_observability = self.observability(epochs)
            keys = np.asarray(keys, dtype=np.uint32)
            out = np.zeros(len(keys))
            by_path = query.path_groups(paths)
            device_ok = (merge == "fragment" and self.fleet is not None
                         and self.fleet.has_device_window(epochs))
            if (failures == "recover" and self.fleet is not None
                    and not device_ok):
                # the device plane recovers inside window_query; the record
                # plane needs the windows patched before it reads them
                self.fleet.recover(epochs)
                failures = "mask"
            if device_ok:
                # one gather per window for every path, single-hop paths
                # (the §4.4 average) apart
                for hop1 in (False, True):
                    part = [(p, i) for p, i in by_path.items()
                            if (len(p) == 1) == hop1]
                    if part:
                        idx = np.concatenate([i for _, i in part])
                        out[idx] = self.fleet.window_query_groups(
                            epochs, keys, part, single_hop=hop1,
                            failures=failures)[idx]
                return out
            level = 0 if self.kind == "um" else None
            for path, idxs in by_path.items():
                recs = self._records_for(path, epochs, failures=failures)
                scale = 1.0
                if failures != "oblivious":
                    # query_window skips blind epochs: extrapolate O_Q from the
                    # observed ones (§4.3's blind-spot fill, over epochs)
                    n_obs, scale = query.window_observability(recs)
                    if not n_obs:
                        raise ValueError(
                            f"no epoch in {list(epochs)} has a live fragment "
                            f"on path {path}; the window is unobservable")
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
        ``failures`` follows ``query_flows``, but the record plane masks
        without extrapolating blind epochs (the G-sum is not additive over
        epochs), while the device plane scales the per-level estimates by
        E / E_observable as the frequency path does.
        """
        with obs.span("disketch.query_entropy"):
            if self.kind != "um":
                raise ValueError(f"query_entropy needs a UnivMon system, this "
                                 f"one is {self.kind!r}")
            if failures not in ("oblivious", "mask", "recover"):
                raise ValueError(f"unknown failure policy {failures!r}")
            self.last_observability = self.observability(epochs)
            by_path = query.path_groups(paths)
            obs.add("path_groups", len(by_path))
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
                    with obs.span("hash.level_of"):
                        lvls.append(H.level_of(ks, level_seed, n_levels))
                if not ests:
                    return 0.0 if total <= 0 else float(np.log2(total))
                s = um_gsum_device(np.concatenate(ests, axis=1),
                                   np.concatenate(lvls), _g_entropy,
                                   k_heavy=k_heavy, device=self.fleet.device)
                if total <= 0:
                    return 0.0
                return float(np.log2(total) - s / total)
            if failures == "recover" and self.fleet is not None:
                self.fleet.recover(epochs)
                failures = "mask"
            recs, keysets = [], []
            for path, idxs in by_path.items():
                recs.append(self._records_for(path, epochs, failures=failures))
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
