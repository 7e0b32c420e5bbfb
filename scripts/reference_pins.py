"""The JAX reference's answers at chip_smoke.py's §6.1 setting: the values
the smoke pins (``RHO["um"]``, ``RMSE_PIN``, ``AGG_RMSE_PIN``,
``ENTROPY_PIN``, ``CHURN_PIN``, ``CONTROL_PIN``), computed on the CPU by
the reference's numpy paths (the loop backend, ``process_epoch``,
``query_window``) and, for the window-8 entropy at k_heavy 1024, its jnp
device G-sum.

    PYTHONPATH=src python scripts/reference_pins.py [SECTION ...]

SECTIONs: rho, aggregated, rmse_epoch, rmse_window, um_epoch, um_window,
churn, control, export (default: all).  Prints one ``name value`` line per
result, then one JSON object.  All sections take a few minutes at this
full-scale setting; ``churn`` alone took 31.8 s (wall) on an 8-core x86
CPU, ``control`` under 45 s, ``export`` under 30 s.

The ``churn`` section runs the smoke's failure schedule
(``churn_schedule``: 5 of 20 switches die at epoch 17 and return at 25,
beside seeded resource pressure).  Its per-epoch values come from the
reference's loop backend through ``Replayer.run(failures=...)``.  Its
window-8 values come from ``ChurnWindowEmulation``, the window path built
from the reference's parts, since the reference's fleet backend cannot
run on a CPU under this jax: ``process_epoch`` with ``ns`` and the widths
frozen per window, dead cells empty and lost cells zeroed after their
PEBs, the reference's own ``apply_event`` and ``_apply_pending_resizes``
on a loop-backend system for the control, and ``query_window(merge=
"fragment")`` for the answers.  ``tests/test_torch_churn.py`` holds the
port to the same emulation at a small size.

The ``control`` section runs the reference's ``VersionedControlPlane``
around its loop backend over the smoke's lossy channels (``lossy_ctrl``):
cs and cms in windows of 8 with no churn, and cs per epoch under
``churn_schedule``.  ``tests/test_torch_control.py`` holds the port's
plane to the same oracle at a small size.

The ``export`` section runs the reference's ``DurableExportPlane`` around
its loop backend over the smoke's lossy export channels
(``lossy_export``), driven window by window through ``run_window`` as the
``control`` section is: cs with checkpoints and a collector crash after
the second window, then a drain (``EXPORT_PIN``'s ``stats()`` and
``crash()`` report); cms with every message of one switch dropped.  A
message's fate depends on ``(seed, frag, epoch, seq)`` alone, so these
protocol values are those of any backend that stages the same cells at
the same rounds.  ``tests/test_torch_export.py`` holds the port's plane
to the same oracle at a small size.
"""
import hashlib
import json
import sys
import tempfile

import numpy as np

from repro.core import equalize as REQ
from repro.core import query as RQ
from repro.core.disketch import (AggregatedSystem, DiscoSystem,
                                 DiSketchSystem, SwitchStream,
                                 _g_entropy, calibrate_rho_target)
from repro.core.fragment import FragmentConfig, process_epoch
from repro.core.hashing import level_of
from repro.core.sketches import true_entropy
from repro.net.channel import LossyChannel
from repro.net.simulator import (ComposedSchedule, FailureSchedule,
                                 Replayer, ResourcePressure, rmse)
from repro.net.topology import FatTree, core_on_path
from repro.net.traffic import gen_workload, gini_memories
from repro.runtime.control import VersionedControlPlane
from repro.runtime.export import DurableExportPlane

# chip_smoke.py's setting
N_FLOWS, N_PACKETS, N_EPOCHS, LOG2_TE, SEED = 200_000, 2_000_000, 32, 16, 1
BASE_MEM, GINI, WINDOW = 128 * 1024, 0.4, 8
RHO = {"cs": 15.67, "cms": 1.0, "um": 63.31}
N_LEVELS, LEVEL_SEED, ENTROPY_EPOCHS = 16, 7777, 8
SECTIONS = ("rho", "aggregated", "rmse_epoch", "rmse_window", "um_epoch",
            "um_window", "churn", "control", "export")
# the churn phase: the window that holds the deaths, and the parity groups
CHURN_EPOCHS, PARITY_GROUP = range(16, 24), 5
# the export phase: protocol rounds after each window dispatch, the
# checkpoint cadence in rounds, the window after which the collector
# crashes, and the switch whose export messages the drop run loses
EXPORT_STEPS, EXPORT_CKPT_EVERY, EXPORT_CRASH_AFTER = 8, 10, 8
EXPORT_VICTIM = 16

out = {}


def save(name, value):
    out[name] = value
    print(name, repr(value), flush=True)


def window_records(rep, mems, kind, **frag_kw):
    """The fleet window path emulated from the reference's parts: each
    window of 8 runs ``process_epoch`` with the n frozen at its start, and
    Eq. 6 is replayed in epoch order at its end."""
    frags = {sw: FragmentConfig(sw, kind, m, **frag_kw)
             for sw, m in mems.items()}
    empty = SwitchStream(np.zeros(0, np.uint32), np.zeros(0, np.int64),
                         np.zeros(0, np.int64))
    ns = {sw: 1 for sw in mems}
    records = {}
    for e0 in range(0, N_EPOCHS, WINDOW):
        frozen, pebs_by_epoch = dict(ns), []
        for e in range(e0, min(e0 + WINDOW, N_EPOCHS)):
            records[e], pebs = {}, {}
            for sw, cfg in frags.items():
                st = rep.epoch_stream(e).get(sw, empty)
                rec = process_epoch(cfg, e, frozen[sw], st.keys, st.values,
                                    st.ts, e << LOG2_TE, LOG2_TE,
                                    single_hop=st.single_hop)
                records[e][sw] = rec
                pebs[sw] = REQ.peb_epoch(rec)
            pebs_by_epoch.append(pebs)
        for pebs in pebs_by_epoch:
            for sw, peb in pebs.items():
                ns[sw] = REQ.next_n(ns[sw], peb, RHO[kind])
    return records


def churn_schedule(n_switches=20):
    """chip_smoke.py's churn: a quarter of the switches die at epoch 17
    (window offset 1) and return at 25, beside seeded resource pressure."""
    return ComposedSchedule([
        FailureSchedule.random(n_switches, 0.25, down_epoch=17, up_epoch=25,
                               seed=3),
        ResourcePressure(n_switches, horizon=N_EPOCHS, seed=5)])


def lossy_ctrl():
    """The smoke's control channels: directives lose 40%, duplicate 20%
    and reorder 30% of copies; ACKs lose 20% and duplicate 20%; both
    delay 0 or 1 extra round."""
    return (LossyChannel(p_drop=0.4, p_dup=0.2, p_reorder=0.3, delay=(0, 1),
                         seed=17),
            LossyChannel(p_drop=0.2, p_dup=0.2, delay=(0, 1), seed=18))


def lossy_export():
    """The smoke's export channels (the reference tests' ``lossy()``):
    data messages lose 30%, duplicate 20% and reorder 30% of copies and
    take 0 to 2 extra rounds; ACKs lose 15%, duplicate 20% and take 0 or
    1 extra round."""
    return (LossyChannel(p_drop=0.3, p_dup=0.2, p_reorder=0.3, delay=(0, 2),
                         seed=9),
            LossyChannel(p_drop=0.15, p_dup=0.2, delay=(0, 1), seed=10))


class DropSwitch(LossyChannel):
    """A lossless channel that drops every message of one switch."""

    def __init__(self, victim, **kw):
        super().__init__(**kw)
        self._victim = victim

    def send(self, msg, now):
        if msg.frag == self._victim:
            self.n_sent += 1
            self.n_dropped += 1
            return
        super().send(msg, now)


def n_log_digest(n_log):
    """A short digest of an n trajectory (one {switch: n} per epoch)."""
    rows = [[[int(sw), int(n)] for sw, n in sorted(d.items())]
            for d in n_log]
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()[:16]


def json_digest(obj):
    """A short digest of a JSON-able object (the control plane's
    ``clamp_log``)."""
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()
                          ).hexdigest()[:16]


class ChurnWindowEmulation:
    """The fleet window path under churn, built from the reference's parts.

    ``ctl`` is a reference ``DiSketchSystem(backend="loop")`` that carries
    the control plane: its ``apply_event``, ``_apply_pending_resizes`` and
    re-equalization run in the order of the reference's fleet
    ``run_window``.  Each window runs ``process_epoch`` at the ``ns`` and
    widths frozen at its start; a dead cell sketches nothing (the fleet
    masks its packets to value 0), and a lost cell is zeroed after its PEB
    is taken.  ``saved`` keeps the lost cells' counters, which parity
    recovery must give back."""

    def __init__(self, streams_of, mems, kind, rho, log2_te, n_epochs,
                 window, schedule, parity_groups=None, subepoching=True,
                 **sys_kw):
        self.kind = kind
        self.parity_groups = parity_groups
        self.ctl = (DiSketchSystem if subepoching else DiscoSystem)(
            mems, kind, rho_target=rho, log2_te=log2_te, **sys_kw)
        ctl = self.ctl
        empty = SwitchStream(np.zeros(0, np.uint32), np.zeros(0, np.int64),
                             np.zeros(0, np.int64))
        self.lost, self.saved, self.ns_by_window = {}, {}, {}
        for e0 in range(0, n_epochs, window):
            eps = list(range(e0, min(e0 + window, n_epochs)))
            events = [schedule.advance(e) for e in eps]
            ctl._apply_pending_resizes()
            for ev in events[0]:
                ctl.apply_event(ev)
            frozen = (dict(ctl.ns) if subepoching
                      else {sw: 1 for sw in ctl.fragments})
            frags = dict(ctl.fragments)
            self.ns_by_window[e0] = frozen
            dead_sets, fail_pts = [frozenset(ctl.dead)], []
            for k in range(1, len(eps)):
                for ev in events[k]:
                    if ev.kind == "fail" and ev.switch not in ctl.dead:
                        fail_pts.append((k, ev.switch))
                    ctl.apply_event(ev, defer_resize=True)
                dead_sets.append(frozenset(ctl.dead))
            lost_sets = [set() for _ in eps]
            for k, sw in fail_pts:
                for k2 in range(k):
                    if sw not in dead_sets[k2]:
                        lost_sets[k2].add(sw)
            window_pebs = []
            for k, e in enumerate(eps):
                recs, pebs = {}, {}
                for sw, cfg in frags.items():
                    st = (empty if sw in dead_sets[k]
                          else streams_of(e).get(sw, empty))
                    rec = process_epoch(cfg, e, frozen[sw], st.keys,
                                        st.values, st.ts, e << log2_te,
                                        log2_te, single_hop=st.single_hop)
                    if sw not in dead_sets[k]:
                        pebs[sw] = REQ.peb_epoch(rec)
                    if sw in lost_sets[k]:
                        self.saved[(e, sw)] = rec.counters.copy()
                        rec.counters[...] = 0
                    recs[sw] = rec
                if lost_sets[k]:
                    self.lost[e] = set(lost_sets[k])
                ctl.records[e] = recs
                window_pebs.append(pebs)
            # the reference's run_window tail: Eq. 6 replayed in order
            for k, e in enumerate(eps):
                if dead_sets[k]:
                    ctl._dead_at[e] = dead_sets[k]
                ctl.peb_log.append(window_pebs[k])
                for sw in window_pebs[k]:
                    ctl._peb_width[sw] = ctl.fragments[sw].width
                if subepoching and not ctl.control_external:
                    for sw, peb in window_pebs[k].items():
                        ctl.ns[sw] = REQ.next_n(ctl.ns[sw], peb, rho)
                ctl.n_log.append(dict(ctl.ns))

    def recoverable(self):
        """``{epoch: [switch]}``: lost cells alone in their parity group."""
        out = {}
        for e in sorted(self.lost):
            for sw in sorted(self.lost[e]):
                group = next((g for g in self.parity_groups or ()
                              if sw in g), None)
                if group is not None and not any(
                        o != sw and o in self.lost[e] for o in group):
                    out.setdefault(e, []).append(sw)
        return out

    def recover(self):
        """Give the recoverable lost cells their counters back."""
        done = self.recoverable()
        for e, sws in done.items():
            for sw in sws:
                self.ctl.records[e][sw].counters[...] = self.saved[(e, sw)]
                self.lost[e].discard(sw)
        return done

    def valid(self, sw, e):
        return (sw not in self.ctl._dead_at.get(e, frozenset())
                and sw not in self.lost.get(e, ()))

    def query(self, keys, paths, epochs, failures, merge="fragment"):
        """``query_flows`` of the fleet under ``failures``: per path group,
        ``query_window`` over the on-path records (all of them under
        "oblivious"; the valid ones, scaled by E / E_observable, under
        "mask"; "recover" recovers first)."""
        if failures == "recover":
            self.recover()
            failures = "mask"
        out = np.zeros(len(keys))
        for path, idxs in path_groups(paths).items():
            recs = [[self.ctl.records[e][sw] for sw in path
                     if failures == "oblivious" or self.valid(sw, e)]
                    for e in epochs]
            scale = 1.0
            if failures != "oblivious":
                n_obs, scale = RQ.window_observability(recs)
                if not n_obs:
                    raise ValueError(f"path {path} is unobservable")
            out[idxs] = RQ.query_window(
                recs, keys[idxs], self.kind,
                single_hop=np.full(len(idxs), len(path) == 1),
                level=0 if self.kind == "um" else None, merge=merge) * scale
        return out


def path_groups(paths):
    groups = {}
    for i, p in enumerate(paths):
        groups.setdefault(tuple(p), []).append(i)
    return {p: np.asarray(i) for p, i in groups.items()}


def main(sections):
    topo = FatTree(4)
    wl = gen_workload(topo, n_flows=N_FLOWS, total_packets=N_PACKETS,
                      n_epochs=N_EPOCHS, log2_te=LOG2_TE, burstiness=0.2,
                      seed=SEED)
    rep = Replayer(wl, topo.n_switches)
    mems = {sw: int(m) for sw, m in enumerate(gini_memories(
        topo.n_switches, BASE_MEM, GINI, np.random.RandomState(SEED + 100)))}
    sel = wl.path_len == 5
    keys, truth = wl.keys[sel], wl.sizes[sel]
    paths = [p for p, s in zip(wl.paths, sel) if s]
    epochs = list(range(N_EPOCHS))
    um_kw = dict(n_levels=N_LEVELS)

    if "rho" in sections:
        save("rho um", calibrate_rho_target(
            mems, "um", rep.epoch_stream(N_EPOCHS // 2), LOG2_TE, **um_kw))
    if "aggregated" in sections:
        core = core_on_path(wl.path_mat[sel], topo.core_ids)
        for kind in ("cs", "cms", "um"):
            agg = AggregatedSystem({sw: mems[sw] for sw in topo.core_ids},
                                   kind, depth=4)
            rep.run(agg)
            save(f"aggregated {kind}",
                 rmse(agg.query_flows(keys, core, epochs), truth))
    if "rmse_epoch" in sections:
        for kind in ("cs", "cms"):
            s = DiSketchSystem(mems, kind, rho_target=RHO[kind],
                               log2_te=LOG2_TE)
            rep.run(s)
            for merge in ("subepoch", "fragment"):
                save(f"{kind} {merge}", rmse(
                    s.query_flows(keys, paths, epochs, merge=merge), truth))
            d = DiscoSystem(mems, kind, rho_target=RHO[kind],
                            log2_te=LOG2_TE)
            rep.run(d)
            save(f"{kind} disco",
                 rmse(d.query_flows(keys, paths, epochs), truth))
    if "rmse_window" in sections:
        for kind in ("cs", "cms"):
            records = window_records(rep, mems, kind)
            est = np.zeros(len(keys))
            for path, idxs in path_groups(paths).items():
                recs = [[records[e][sw] for sw in path] for e in epochs]
                est[idxs] = RQ.query_window(
                    recs, keys[idxs], kind,
                    single_hop=np.full(len(idxs), False), level=None,
                    merge="fragment")
            save(f"{kind} window {WINDOW}", rmse(est, truth))
    if "um_epoch" in sections:
        es = list(range(ENTROPY_EPOCHS))
        in_es = (wl.pkt_ts >> LOG2_TE) < ENTROPY_EPOCHS
        total = float(in_es.sum())
        save(f"true entropy, epochs 0-{ENTROPY_EPOCHS - 1}", true_entropy(
            np.bincount(wl.pkt_flow[in_es], minlength=len(wl.keys))))
        q_kw = dict(n_levels=N_LEVELS, level_seed=LEVEL_SEED)
        s = DiSketchSystem(mems, "um", rho_target=RHO["um"],
                           log2_te=LOG2_TE, **um_kw)
        rep.run(s)
        save("disketch subepoch",
             s.query_entropy(wl.keys, wl.paths, es, total, **q_kw))
        save("disketch fragment", s.query_entropy(
            wl.keys, wl.paths, es, total, merge="fragment",
            k_heavy=len(wl.keys), **q_kw))
        d = DiscoSystem(mems, "um", rho_target=RHO["um"], log2_te=LOG2_TE,
                        **um_kw)
        rep.run(d)
        save("disco subepoch",
             d.query_entropy(wl.keys, wl.paths, es, total, **q_kw))
    if "um_window" in sections:
        from repro.kernels.sketch_query import um_gsum_device

        records = window_records(rep, mems, "um", **um_kw)
        total = float(len(wl.pkt_ts))
        save(f"true entropy, epochs 0-{N_EPOCHS - 1}",
             true_entropy(wl.sizes))
        # um_gsum_window's per-level estimates, in path-group order
        ests, lvls = [], []
        for path, idxs in path_groups(wl.paths).items():
            kk = wl.keys[idxs]
            recs = [[records[e][sw] for sw in path] for e in epochs]
            lvl = level_of(kk, LEVEL_SEED, N_LEVELS)
            est = np.zeros((N_LEVELS, len(kk)))
            for l in range(N_LEVELS):
                m = lvl >= l
                if m.any():
                    est[l, m] = RQ.query_window(recs, kk[m], "um", level=l,
                                                merge="fragment")
            ests.append(est)
            lvls.append(lvl)
        ests, lvl = np.concatenate(ests, axis=1), np.concatenate(lvls)

        def entropy(s):
            return float(np.log2(total) - s / total)

        g = lambda x: x * np.log2(np.maximum(x, 1.0))    # noqa: E731
        save("window 8 fragment", entropy(
            RQ.um_gsum_combine(ests, lvl, g, k_heavy=len(wl.keys))))
        # k_heavy 1024 binds: lax.top_k's order (ties to the lower index)
        save("window 8 fragment k_heavy 1024", entropy(
            um_gsum_device(ests, lvl, _g_entropy, k_heavy=1024)))
    if "churn" in sections:
        churn(wl, rep, mems, keys, truth, paths, epochs)
    if "control" in sections:
        control(wl, rep, mems, keys, truth, paths, epochs)
    if "export" in sections:
        export(rep, mems)
    print(json.dumps(out))


def truth_over(wl, es):
    """The 5-hop flows' true sizes over the epochs ``es``."""
    in_es = np.isin(wl.pkt_ts >> LOG2_TE, list(es))
    return np.bincount(wl.pkt_flow[in_es],
                       minlength=len(wl.keys))[wl.path_len == 5]


def churn(wl, rep, mems, keys, truth, paths, epochs):
    """The churn phase's pins: per-epoch cs on the loop backend, window 8
    (cs and cms, parity groups of 5) on ``ChurnWindowEmulation``."""
    es = list(CHURN_EPOCHS)
    truth_es = truth_over(wl, es)
    s = DiSketchSystem(mems, "cs", rho_target=RHO["cs"], log2_te=LOG2_TE)
    rep.run(s, failures=churn_schedule())
    save("churn epoch dead_at", {int(e): sorted(int(x) for x in d)
                                 for e, d in sorted(s._dead_at.items())})
    save("churn epoch cs n_log", n_log_digest(s.n_log))
    save("churn epoch cs clamps", len(s.clamp_log))
    for failures in ("mask", "oblivious"):
        save(f"churn epoch cs {failures}", rmse(s.query_flows(
            keys, paths, es, failures=failures), truth_es))
    groups = [list(range(i, i + PARITY_GROUP))
              for i in range(0, len(mems), PARITY_GROUP)]
    for kind in ("cs", "cms"):
        em = ChurnWindowEmulation(rep.epoch_stream, mems, kind, RHO[kind],
                                  LOG2_TE, N_EPOCHS, WINDOW,
                                  churn_schedule(), parity_groups=groups)
        save(f"churn window {kind} n_log", n_log_digest(em.ctl.n_log))
        save(f"churn window {kind} lost",
             {int(e): sorted(int(x) for x in sws)
              for e, sws in sorted(em.lost.items())})
        save(f"churn window {kind} recoverable",
             {int(e): [int(x) for x in sws]
              for e, sws in em.recoverable().items()})
        for failures in ("oblivious", "mask", "recover"):
            save(f"churn window {kind} {failures}", rmse(em.query(
                keys, paths, epochs, failures), truth))
        if kind == "cs":
            # the record plane (subepoch merge) of the churn window, after
            # "recover": its dead cells hold zero records, which "oblivious"
            # merges and "mask" drops
            for failures in ("mask", "oblivious"):
                save(f"churn window cs records {failures}", rmse(em.query(
                    keys, paths, es, failures, merge="subepoch"), truth_es))


def control(wl, rep, mems, keys, truth, paths, epochs):
    """The control phase's pins: the reference's plane around its loop
    backend, over ``lossy_ctrl``'s channels."""
    def plane(kind, channels=None):
        return VersionedControlPlane(
            DiSketchSystem(mems, kind, rho_target=RHO[kind], log2_te=LOG2_TE),
            *(lossy_ctrl() if channels is None else channels))

    for kind, channels in (("cs", ()), ("cs", None), ("cms", None)):
        name = f"control window {kind}" + (" lossless" if channels == ()
                                           else "")
        p = plane(kind, channels)
        # run_window is called directly: Replayer.run would run a system
        # without a fleet epoch by epoch whatever the window, and the
        # plane would react every epoch.  Called directly, the loop
        # backend runs the window's epochs with ns unchanged (external
        # control) and _post_dispatch walks the window's PEBs once: the
        # fleet window path's semantics.
        for e0 in range(0, N_EPOCHS, WINDOW):
            p.run_window(e0, [rep.epoch_stream(e) for e in
                              range(e0, min(e0 + WINDOW, N_EPOCHS))])
        save(f"{name} applied", n_log_digest(p.applied_log))
        save(f"{name} stale", p.stale_epochs())
        save(f"{name} stats", p.stats())
        save(f"{name} rmse", rmse(p.query_flows(keys, paths, epochs,
                                                merge="fragment"), truth))
    # per epoch under churn, through the reference's own Replayer.run
    es = list(CHURN_EPOCHS)
    p = plane("cs")
    rep.run(p, failures=churn_schedule())
    save("control epoch cs applied", n_log_digest(p.applied_log))
    save("control epoch cs clamps", p.clamp_log)
    save("control epoch cs clamps digest", json_digest(p.clamp_log))
    save("control epoch cs stats", p.stats())
    save("control epoch cs stale", p.stale_epochs())
    est = p.query_flows(keys, paths, es, failures="mask")
    save("control epoch cs stale_config",
         p.last_observability["stale_config"])
    save("control epoch cs rmse", rmse(est, truth_over(wl, es)))


def export(rep, mems):
    """The export phase's pins: the reference's plane around its loop
    backend over ``lossy_export``'s channels, window by window (its
    ``Replayer.run`` would stage and step once an epoch)."""
    def windows(p, after=None):
        for e0 in range(0, N_EPOCHS, WINDOW):
            p.run_window(e0, [rep.epoch_stream(e) for e in
                              range(e0, min(e0 + WINDOW, N_EPOCHS))])
            if after is not None and e0 == EXPORT_CRASH_AFTER:
                after(p)

    crashes = []
    with tempfile.TemporaryDirectory() as d:
        p = DurableExportPlane(
            DiSketchSystem(mems, "cs", rho_target=RHO["cs"],
                           log2_te=LOG2_TE), *lossy_export(),
            max_retries=12, ckpt_dir=d, ckpt_every=EXPORT_CKPT_EVERY,
            ckpt_keep=2, steps_per_dispatch=EXPORT_STEPS)
        windows(p, after=lambda p: crashes.append(p.crash()))
        p.drain()
        crash = dict(crashes[0])
        restaged = crash.pop("restaged")
        save("export crash", dict(crash, n_restaged=len(restaged),
                                  restaged=json_digest(restaged)))
        save("export stats", p.stats())
        save("export checkpoints", p._ckpt_step)
    p = DurableExportPlane(
        DiSketchSystem(mems, "cms", rho_target=RHO["cms"], log2_te=LOG2_TE),
        DropSwitch(EXPORT_VICTIM, seed=4), max_retries=2,
        steps_per_dispatch=EXPORT_STEPS)
    windows(p)
    p.drain()
    save("export drop lost", sorted(p.lost_cells()))
    save("export drop stats", p.stats())


if __name__ == "__main__":
    chosen = sys.argv[1:] or SECTIONS
    unknown = set(chosen) - set(SECTIONS)
    if unknown:
        raise SystemExit(f"unknown sections {sorted(unknown)}; "
                         f"choose from {SECTIONS}")
    main(chosen)
