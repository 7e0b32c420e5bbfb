"""The port's durable export plane (``repro_torch.runtime.export``) and the
fleet's export hooks against the JAX package's.

Three groups of tests:

* the reference's own suite (``tests/test_export.py``, its exporter, plane
  and ``Replayer`` tests) carried over to the port at the same fixture:
  4 switches, cms, rho_target 5.0, log2_te 10, 4 epochs, one window of 4
  on the fleet backend (``device="cpu"`` where the reference passes
  ``interpret=True``).  Each backend is held to its own run without the
  plane, as the reference's suite holds its own;
* protocol parity with the reference's plane around its **loop** backend
  (its fleet backend does not run on a CPU: its Pallas calls fail under
  jax 0.9).  A message's fate is drawn from ``(seed, frag, epoch, seq)``
  alone and exporters send in sorted (switch, epoch) order, so the
  protocol's trace depends only on which cells were staged and when:
  the reference's loop-backend plane, driven through ``run_window``
  window by window, gives the port's fleet plane (and its loop plane) its
  exact ``stats()``, applied and dedup sets, lost and pending cells,
  exporter state and ``crash()`` reports;
* cell parity: with ``control_external`` set on both systems (``ns``
  frozen at a mixed setting), the reference's loop backend runs each
  window as the fleet does, so every drained cell of the port's fleet
  equals the reference's loop record bit for bit, also after a crash, and
  the queries agree (exactly between the loop backends, within 1e-6
  relative across backends).

The fleet's hooks patch each cell's live ``(L, n, width)`` block in the
resident window, never a padded one, and staging a window copies only
those blocks to the host.
"""
import os

import numpy as np
import pytest
import torch

from repro.core.disketch import DiSketchSystem as RSystem
from repro.core.disketch import SwitchStream as RStream
from repro.net.channel import LossyChannel as RChannel
from repro.runtime.export import DurableExportPlane as RPlane
from repro_torch.core.disketch import DiSketchSystem, SwitchStream
from repro_torch.core.fleet import parity_groups_chunked
from repro_torch.net.channel import LossyChannel
from repro_torch.net.simulator import FailureSchedule, Replayer
from repro_torch.runtime import (AckMsg, Collector, DurableExportPlane,
                                 ExportMsg, SwitchExporter)
from torch_threads import one_thread  # noqa: F401

SW = 4
LOG2_TE = 10
MEMS = {sw: 256 for sw in range(SW)}
KEYS = np.arange(40).astype(np.uint32)
EPOCHS = [0, 1, 2, 3]
PATHS = [tuple(range(SW))] * len(KEYS)
BACKENDS = ["loop", "fleet"]


def streams_for(epoch, seed, cls=SwitchStream, n_pkts=200, n_keys=40):
    r = np.random.default_rng(seed)
    out = {}
    for sw in range(SW):
        keys = r.integers(0, n_keys, n_pkts).astype(np.uint32)
        ts = ((epoch << LOG2_TE)
              + np.sort(r.integers(0, 1 << LOG2_TE, n_pkts)).astype(
                  np.int64))
        out[sw] = cls(keys, np.ones(n_pkts, np.int64), ts)
    return out


STREAMS = [streams_for(e, 100 + e) for e in range(4)]
R_STREAMS = [streams_for(e, 100 + e, RStream) for e in range(4)]


def build(backend="fleet", kind="cms"):
    kw = dict(device="cpu") if backend == "fleet" else {}
    return DiSketchSystem(MEMS, kind, rho_target=5.0, log2_te=LOG2_TE,
                          backend=backend, **kw)


def run_all(plane_or_sys, backend):
    if backend == "fleet":
        plane_or_sys.run_window(0, STREAMS)
    else:
        for e in range(4):
            plane_or_sys.run_epoch(e, STREAMS[e])


def oracle_cells(backend):
    """{(sw, e): exact int32 counters} of a lossless, plane-free run."""
    sys_ = build(backend)
    run_all(sys_, backend)
    if backend == "fleet":
        return sys_, {(sw, e): sys_.fleet.cell_counters(e, sw)
                      for e in EPOCHS for sw in sys_.fleet.frag_order}
    return sys_, {(sw, e): np.asarray(
        sys_.records[e][sw].counters).astype(np.int32)
        for e in EPOCHS for sw in range(SW)}


def plane_cells(plane, backend):
    if backend == "fleet":
        fl = plane.system.fleet
        return {(sw, e): fl.cell_counters(e, sw)
                for e in EPOCHS for sw in fl.frag_order}
    return {(sw, e): np.asarray(rec.counters).astype(np.int32)
            for e in EPOCHS
            for sw, rec in plane.system.records[e].items()}


def lossy(seed=9, p_drop=0.3, cls=LossyChannel):
    return (cls(p_drop=p_drop, p_dup=0.2, p_reorder=0.3, delay=(0, 2),
                seed=seed),
            cls(p_drop=0.5 * p_drop, p_dup=0.2, delay=(0, 1), seed=seed + 1))


# -- SwitchExporter -----------------------------------------------------------

class _Recorder:
    """Channel stub that records (round, seq) of every send."""

    def __init__(self):
        self.sent = []

    def send(self, msg, now):
        self.sent.append((now, msg.seq))


def test_exporter_backoff_schedule_and_budget():
    exp = SwitchExporter(0, max_retries=3, backoff0=1, backoff_max=4)
    exp.stage(5, np.ones(2, np.int32), now=0)
    rec = _Recorder()
    for t in range(1, 20):
        exp.tick(t, rec)
    # waits 1, 2, 4, 4 (capped) rounds between attempts, then gives up
    assert rec.sent == [(1, 0), (2, 1), (4, 2), (8, 3)]
    assert exp.exhausted_epochs() == [5]
    assert exp.unfinished() == []
    assert exp.n_tx == 4


def test_exporter_ack_stops_retransmission_and_release_drops():
    exp = SwitchExporter(0, max_retries=8)
    exp.stage(1, np.ones(2, np.int32), now=0)
    rec = _Recorder()
    exp.tick(1, rec)
    exp.on_ack(1)
    for t in range(2, 10):
        exp.tick(t, rec)
    assert rec.sent == [(1, 0)]        # ACK silenced the retry loop
    assert 1 in exp.entries            # retained until commit
    exp.release(1)
    assert exp.entries == {}


def test_exporter_resync_keeps_exhausted_dead():
    exp = SwitchExporter(0, max_retries=0)
    exp.stage(1, np.ones(2, np.int32), now=0)
    exp.stage(2, np.ones(2, np.int32), now=0)
    rec = _Recorder()
    exp.tick(1, rec)                   # both exhausted (budget 0)
    assert sorted(exp.exhausted_epochs()) == [1, 2]
    restaged = exp.resync(applied={(0, 1)}, now=5)
    # epoch 1 was applied -> re-ACKed; epoch 2 stays exhausted (its loss
    # was already reported and must not silently un-happen)
    assert restaged == []
    assert exp.entries[1].acked and exp.exhausted_epochs() == [2]


def test_exporter_validation():
    with pytest.raises(ValueError):
        SwitchExporter(0, max_retries=-1)
    with pytest.raises(ValueError):
        SwitchExporter(0, backoff0=4, backoff_max=2)


def test_messages_and_collector_state():
    m = ExportMsg(2, 3, 1, np.zeros((1, 2, 2), np.int32))
    a = AckMsg(2, 3, 1)
    assert (m.frag, m.epoch, m.seq) == (a.frag, a.epoch, a.seq)
    c = Collector()
    c.applied.add((2, 3))
    c.dedup.add((2, 3, 1))
    c.clear()
    assert c.applied == set() and c.dedup == set()
    assert (c.n_rx, c.n_dup_rx) == (0, 0)


# -- plane composition limits ---------------------------------------------------

def test_plane_rejects_parity_groups():
    sys_ = DiSketchSystem(MEMS, "cms", rho_target=5.0, log2_te=LOG2_TE,
                          device="cpu",
                          fleet_kwargs={"parity_groups":
                                        parity_groups_chunked(
                                            tuple(range(SW)), 2)})
    with pytest.raises(ValueError, match="parity"):
        DurableExportPlane(sys_)


def test_plane_rejects_per_epoch_fleet():
    plane = DurableExportPlane(build("fleet"))
    with pytest.raises(ValueError, match="window mode"):
        plane.run_epoch(0, STREAMS[0])


def test_checkpoint_needs_a_directory():
    plane = DurableExportPlane(build("loop"))
    with pytest.raises(ValueError, match="ckpt_dir"):
        plane.checkpoint()


# -- drained bit-identity ---------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_drained_plane_bit_identical_to_oracle(backend):
    oracle_sys, want = oracle_cells(backend)
    plane = DurableExportPlane(build(backend), *lossy(), max_retries=12)
    run_all(plane, backend)
    # nothing delivered yet: every cell is pending, none lost
    assert len(plane.pending_cells()) == SW * 4
    plane.drain()
    assert plane.lost_cells() == set() and plane.pending_cells() == set()
    got = plane_cells(plane, backend)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    est = plane.query_flows(KEYS, PATHS, EPOCHS, failures="mask")
    ref = oracle_sys.query_flows(KEYS, PATHS, EPOCHS, failures="mask")
    assert np.array_equal(est, ref)
    s = plane.stats()
    assert s["n_applied"] == SW * 4
    assert s["n_tx"] > SW * 4          # drops forced retransmissions
    if backend == "fleet":
        fl = plane.system.fleet
        assert not fl._unexported      # every hold-back was patched back
        assert not fl._row_live        # and the no-failure fast path is back


@pytest.mark.parametrize("backend", BACKENDS)
def test_duplicate_deliveries_apply_once(backend):
    _, want = oracle_cells(backend)
    plane = DurableExportPlane(
        build(backend),
        LossyChannel(p_dup=1.0, delay=(0, 2), seed=2),
        LossyChannel(p_dup=1.0, seed=3))
    run_all(plane, backend)
    plane.drain()
    assert plane.collector.n_dup_rx > 0
    got = plane_cells(plane, backend)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


# -- loss accounting ----------------------------------------------------------------

def _drop_frag(frag, base=LossyChannel, **kw):
    """A ``base`` channel (the port's or the reference's), lossless except
    for one fragment's messages (all dropped)."""
    class DropFrag(base):
        def send(self, msg, now):
            if getattr(msg, "frag", None) == frag:
                self.n_sent += 1
                self.n_dropped += 1
                return
            super().send(msg, now)

    return DropFrag(**kw)


@pytest.mark.parametrize("backend", BACKENDS)
def test_exhausted_budget_reports_exact_losses(backend):
    plane = DurableExportPlane(build(backend), _drop_frag(2, seed=4),
                               max_retries=2)
    run_all(plane, backend)
    plane.drain()
    assert plane.lost_cells() == {(2, e) for e in EPOCHS}
    obs = plane.observability(EPOCHS)
    assert obs["lost"] == [(2, e) for e in EPOCHS]
    assert obs["observable_cells"] == (SW - 1) * len(EPOCHS)
    # masked merge over a path containing the lost fragment equals the
    # survivors-only oracle (exactly — min/median simply skip the cell)
    oracle_sys, _ = oracle_cells(backend)
    paths = [(1, 2, 3)] * len(KEYS)
    est = plane.query_flows(KEYS, paths, EPOCHS, failures="mask")
    ref = oracle_sys.query_flows(KEYS, [(1, 3)] * len(KEYS), EPOCHS,
                                 failures="mask")
    assert np.array_equal(est, ref)
    # the oblivious policy instead merges the zeroed hold-back
    obl = plane.query_flows(KEYS, paths, EPOCHS, failures="oblivious")
    truth_gap_masked = np.abs(est - ref).max()
    assert truth_gap_masked == 0.0
    if backend == "fleet":
        # zeros poison the min-merge: oblivious underestimates hard
        assert (obl <= est).all() and (obl < est).any()
        # and the device plane agrees with the record plane
        dev = plane.query_flows(KEYS, paths, EPOCHS, merge="fragment",
                                failures="mask")
        np.testing.assert_allclose(dev, oracle_sys.query_flows(
            KEYS, [(1, 3)] * len(KEYS), EPOCHS, merge="fragment"),
            rtol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_late_arrivals_sharpen_queries(backend):
    oracle_sys, _ = oracle_cells(backend)
    plane = DurableExportPlane(
        build(backend), LossyChannel(delay=(4, 8), seed=5),
        LossyChannel(seed=6), max_retries=8)
    run_all(plane, backend)
    for _ in range(3):                 # some cells landed, some in flight
        plane.step()
    mid_pending = plane.observability(EPOCHS)["pending"]
    assert mid_pending
    plane.drain()
    obs = plane.observability(EPOCHS)
    assert obs["pending"] == [] and obs["lost"] == []
    assert obs["scale"] == 1.0
    est = plane.query_flows(KEYS, PATHS, EPOCHS, failures="mask")
    ref = oracle_sys.query_flows(KEYS, PATHS, EPOCHS, failures="mask")
    assert np.array_equal(est, ref)


@pytest.mark.parametrize("backend", BACKENDS)
def test_observability_stamped_on_query(backend):
    plane = DurableExportPlane(build(backend), *lossy(), max_retries=12)
    run_all(plane, backend)
    plane.drain()
    plane.query_flows(KEYS, PATHS, EPOCHS, failures="mask")
    for holder in (plane, plane.system):
        o = holder.last_observability
        assert o is not None
        assert o["epochs"] == 4 and o["scale"] == 1.0
    assert plane.last_observability["pending"] == []
    assert plane.last_observability["lost"] == []


# -- collector crash / recovery ---------------------------------------------------

def _crash_run(plane):
    """The crash schedule of the reference's crash test, after the
    dispatch: 3 rounds, a checkpoint, 3 more rounds (cells applied and
    ACKed after it: the at-least-once crash window), the crash."""
    for _ in range(3):
        plane.step()
    step = plane.checkpoint()
    n_committed = len(plane.collector.applied)
    for _ in range(3):
        plane.step()
    n_at_crash = len(plane.collector.applied)
    info = plane.crash()
    return step, n_committed, n_at_crash, info


@pytest.mark.parametrize("backend", BACKENDS)
def test_crash_recovery_bit_identity(backend, tmp_path):
    oracle_sys, want = oracle_cells(backend)
    plane = DurableExportPlane(build(backend), *lossy(seed=21),
                               max_retries=12,
                               ckpt_dir=str(tmp_path / "ck"))
    run_all(plane, backend)
    step, n_committed, n_at_crash, info = _crash_run(plane)
    assert info["restored_step"] == step
    assert info["restored_cells"] == n_committed
    assert info["dropped_cells"] == n_at_crash
    # everything newer than the checkpoint must be retransmittable
    assert len(info["restaged"]) >= n_at_crash - n_committed
    plane.drain()
    assert plane.lost_cells() == set() and plane.pending_cells() == set()
    got = plane_cells(plane, backend)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    est = plane.query_flows(KEYS, PATHS, EPOCHS, failures="mask")
    ref = oracle_sys.query_flows(KEYS, PATHS, EPOCHS, failures="mask")
    assert np.array_equal(est, ref)


@pytest.mark.parametrize("backend", BACKENDS)
def test_crash_without_checkpoint_dir_recovers_by_full_retransmit(backend):
    _, want = oracle_cells(backend)
    plane = DurableExportPlane(build(backend), *lossy(seed=22),
                               max_retries=12)
    run_all(plane, backend)
    for _ in range(4):
        plane.step()
    info = plane.crash()
    assert info["restored_step"] is None and info["restored_cells"] == 0
    plane.drain()
    got = plane_cells(plane, backend)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("backend", BACKENDS)
def test_checkpoint_releases_committed_payloads(backend, tmp_path):
    plane = DurableExportPlane(build(backend),
                               ckpt_dir=str(tmp_path / "ck"), max_retries=4)
    run_all(plane, backend)
    plane.drain()                      # lossless default channel
    assert len(plane.collector.applied) == SW * 4
    retained = sum(len(x.entries) for x in plane.exporters.values())
    assert retained == SW * 4          # ACK alone never releases
    plane.checkpoint()
    assert sum(len(x.entries) for x in plane.exporters.values()) == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_auto_checkpoint_cadence(backend, tmp_path):
    plane = DurableExportPlane(build(backend),
                               LossyChannel(delay=(0, 3), seed=8),
                               ckpt_dir=str(tmp_path / "ck"),
                               ckpt_every=2, max_retries=4)
    run_all(plane, backend)
    plane.drain()
    assert plane._ckpt_step >= 1
    steps = [n for n in os.listdir(str(tmp_path / "ck"))
             if n.startswith("step_") and not n.endswith(".tmp")]
    assert steps
    assert len(steps) <= plane.ckpt_keep


# -- Replayer composition -----------------------------------------------------------

def _small_workload():
    from repro_torch.net.topology import FatTree
    from repro_torch.net.traffic import gen_workload
    topo = FatTree(4)
    wl = gen_workload(topo, n_flows=400, total_packets=4_000, n_epochs=4,
                      burstiness=0.2, seed=13)
    return topo, wl


def test_replayer_composes_churn_and_lossy_channel():
    topo, wl = _small_workload()
    rep = Replayer(wl, topo.n_switches)
    sched = FailureSchedule(topo.n_switches, downs={3: (2, None)})
    sys_ = DiSketchSystem({sw: 256 for sw in range(topo.n_switches)},
                          "cms", rho_target=5.0, log2_te=wl.log2_te,
                          device="cpu")
    plane = DurableExportPlane(sys_, *lossy(seed=31), max_retries=12)
    rep.run(plane, window=2, failures=sched)
    plane.drain()
    # the dead switch's epochs were never sketched, so never staged
    staged = {(sw, e) for sw, exp in plane.exporters.items()
              for e in exp.entries}
    assert not any(sw == 3 and e >= 2 for sw, e in staged)
    assert not any(sw == 3 and e >= 2
                   for sw, e in plane.collector.applied)
    assert plane.lost_cells() == set()
    est = plane.query_flows(wl.keys[:20], [wl.paths[i] for i in range(20)],
                            list(range(4)), failures="mask")
    assert np.isfinite(est).all()


def test_replayer_packet_lru_invalidation():
    topo, wl = _small_workload()
    rep = Replayer(wl, topo.n_switches)
    order = tuple(range(topo.n_switches))
    p1 = rep.epoch_packet(0, order)
    assert rep.epoch_packet(0, order) is p1        # LRU hit
    assert rep.invalidate_packets([0]) == 1
    p2 = rep.epoch_packet(0, order)
    assert p2 is not p1                             # rebuilt
    np.testing.assert_array_equal(p1.keys, p2.keys)
    assert rep.invalidate_packets([5, 6]) == 0      # not cached: no-op


def test_replayer_churn_results_unaffected_by_warm_cache():
    # a failure/recovery cycle must evict packed-epoch LRU entries, so a
    # pre-warmed cache gives the same answer as a cold one
    topo, wl = _small_workload()
    mems = {sw: 256 for sw in range(topo.n_switches)}

    def run_one(warm):
        rep = Replayer(wl, topo.n_switches)
        sys_ = DiSketchSystem(mems, "cms", rho_target=5.0,
                              log2_te=wl.log2_te, device="cpu")
        if warm:
            for e in range(wl.n_epochs):
                rep.epoch_packet(e, sys_.fleet.frag_order)
        sched = FailureSchedule(topo.n_switches, downs={1: (1, 3)})
        rep.run(sys_, window=2, failures=sched)
        return sys_.query_flows(wl.keys[:20],
                                [wl.paths[i] for i in range(20)],
                                list(range(4)), failures="mask")

    assert np.array_equal(run_one(warm=False), run_one(warm=True))


def test_replayer_window_plane_equals_plane_free_run():
    """``Replayer.run(plane, window=2)`` with the plane stepping between
    dispatches, drained: the resident windows equal a plane-free replay
    and stay on their device."""
    topo, wl = _small_workload()
    mems = {sw: 256 for sw in range(topo.n_switches)}
    free = DiSketchSystem(mems, "cs", rho_target=5.0, log2_te=wl.log2_te,
                          device="cpu")
    Replayer(wl, topo.n_switches).run(free, window=2)
    plane = DurableExportPlane(
        DiSketchSystem(mems, "cs", rho_target=5.0, log2_te=wl.log2_te,
                       device="cpu"),
        *lossy(seed=33), max_retries=12, steps_per_dispatch=3)
    Replayer(wl, topo.n_switches).run(plane, window=2)
    assert plane.pending_cells()       # some cells still in flight
    plane.drain()
    assert plane.lost_cells() == set() and not plane.fleet._unexported
    assert plane.system.n_log == free.n_log
    for w0 in (0, 2):
        got = plane.fleet._window_bufs[w0][0]
        want = free.fleet._window_bufs[w0][0]
        assert got.resident and got._host is None
        for (rows, c), (rows_w, c_w) in zip(got.device(), want.device(),
                                            strict=True):
            assert np.array_equal(rows, rows_w) and torch.equal(c, c_w)


# -- the fleet's hooks ------------------------------------------------------------------

def _fleet_window(kind="cms", ns=None):
    sys_ = build("fleet", kind)
    if ns is not None:
        sys_.control_external = True
        sys_.ns.update(ns)
    sys_.run_window(0, STREAMS)
    return sys_


def test_hooks_patch_the_live_block():
    sys_ = _fleet_window("cs", ns={0: 1, 1: 2, 2: 4, 3: 2})
    fl = sys_.fleet
    buf = fl._window_bufs[2][0]
    before = [(rows, c.clone()) for rows, c in buf.device()]
    cell = fl.cell_counters(2, 2)
    assert cell.shape == (1, 4, fl.fragments[2].width) and cell.any()
    fl.mark_unexported(2, [2])
    assert not fl.cell_counters(2, 2).any()
    assert fl._unexported == {2: {2}}
    assert fl.frag_live(2).tolist() == [True, True, False, True]
    assert not fl.is_live(2, 2) and fl.is_live(1, 2)
    # only the cell's block changed, nothing beyond it and no other epoch
    for (rows, c), (_, c0) in zip(buf.device(), before):
        diff = (c != c0).nonzero()
        if len(diff):
            assert set(diff[:, 0].tolist()) == {2}
            assert set(rows[diff[:, 1].unique().numpy()].tolist()) == {2}
    with pytest.raises(ValueError, match="live block"):
        fl.deliver_cell(2, 2, np.zeros((1, 8, fl.fragments[2].width),
                                       np.int32))
    fl.deliver_cell(2, 2, cell)
    assert fl._unexported == {} and fl._row_live == {}
    for (_, c), (_, c0) in zip(buf.device(), before):
        assert torch.equal(c, c0)
    with pytest.raises(KeyError):
        fl.mark_unexported(9, [0])
    with pytest.raises(KeyError):
        fl.deliver_cell(9, 0, cell)


def test_hooks_work_on_the_host_copy():
    sys_ = _fleet_window("cms", ns={0: 2, 1: 1, 2: 1, 3: 4})
    fl = sys_.fleet
    want = fl.cell_counters(1, 3)
    sys_.records[1][0]                  # touch a record: host copy
    buf = fl._window_bufs[1][0]
    assert not buf.resident
    fl.mark_unexported(1, [3])
    assert not sys_.records[1][3].counters.any()   # the views see it
    fl.deliver_cell(1, 3, want)
    np.testing.assert_array_equal(sys_.records[1][3].counters, want[0])
    assert fl._row_live == {}


def test_hold_back_is_its_own_domain_and_reprocessing_clears_it():
    sys_ = _fleet_window("cms")
    fl = sys_.fleet
    fl.mark_unexported(0, [1, 3])
    fl.mark_unexported(3, [0])
    assert fl._lost == {}              # not parity's domain
    assert fl._unexported == {0: {1, 3}, 3: {0}}
    sys_.run_window(0, STREAMS)        # the epochs are reprocessed
    assert fl._unexported == {} and fl._row_live == {}


def test_hold_back_leaves_recorded_rows_alone():
    """A per-epoch run with a dead switch shares its liveness array with
    ``_recorded`` (the rows that exported a record): holding a cell back
    must not change what an "oblivious" merge sees as recorded."""
    sys_ = DiSketchSystem(MEMS, "cms", rho_target=5.0, log2_te=LOG2_TE,
                          device="cpu", fleet_kwargs={"keep_stacked": True})
    fl = sys_.fleet
    sys_.dead.add(0)
    sys_.run_epoch(0, STREAMS[0])
    assert fl._row_live[0] is fl._recorded[0]
    recorded = fl._recorded[0].copy()
    fl.mark_unexported(0, [2])
    assert np.array_equal(fl._recorded[0], recorded)
    assert fl._row_live[0].tolist() == [False, True, False, True]
    fl.deliver_cell(0, 2, np.zeros(
        (1,) + fl._block_shape(fl._params_log[0], 2), np.int32))
    assert fl._row_live[0].tolist() == [False, True, True, True]
    assert np.array_equal(fl._recorded[0], recorded)


def test_staging_copies_only_the_live_blocks():
    """One narrow fragment at n = 256 beside wide ones at n = 1: staging the
    window copies each cell's live int32 block to the host (the window
    stays on its device), and the bytes retained on the switches are
    those blocks, within 1.1x of the window's int32 row groups and far
    below the padded ``(E, R, n_sub_max, width_max)`` window."""
    mems = {sw: 8 * 1024 for sw in range(SW)}
    mems[1] = 1024
    sys_ = DiSketchSystem(mems, "cs", rho_target=5.0, log2_te=LOG2_TE,
                          device="cpu")
    sys_.control_external = True
    sys_.ns[1] = 256
    plane = DurableExportPlane(sys_, *lossy(seed=3), max_retries=12)
    run_all(plane, "fleet")
    fl = sys_.fleet
    buf = fl._window_bufs[0][0]
    assert buf.resident and buf._host is None
    payloads = [ent.payload for exp in plane.exporters.values()
                for ent in exp.entries.values()]
    assert len(payloads) == SW * len(EPOCHS)
    assert all(p.dtype == np.int32 for p in payloads)
    staged = sum(p.nbytes for p in payloads)
    live = sum(4 * fl.fragments[sw].width * (256 if sw == 1 else 1)
               for sw in range(SW)) * len(EPOCHS)
    groups = sum(c.numel() * 4 for _, c in buf.device())
    padded = int(np.prod(buf._shape)) * 4
    assert staged == live
    assert staged <= 1.1 * groups
    assert padded > 2 * staged
    plane.drain()
    assert buf.resident and buf._host is None
    assert plane.lost_cells() == set() and not fl._unexported


# -- protocol parity with the reference's loop-backend plane --------------------------

def _ref_plane(channels, **kw):
    return RPlane(RSystem(MEMS, "cms", rho_target=5.0, log2_te=LOG2_TE,
                          backend="loop"), *channels, **kw)


def _protocol(plane):
    """Everything of the protocol's state the two packages must share."""
    return dict(
        stats=plane.stats(), applied=set(plane.collector.applied),
        dedup=set(plane.collector.dedup), lost=plane.lost_cells(),
        pending=plane.pending_cells(),
        obs={k: plane.observability(EPOCHS)[k] for k in ("pending", "lost")},
        exporters={sw: (exp.n_tx, sorted(exp.entries),
                        sorted(exp.exhausted_epochs()))
                   for sw, exp in plane.exporters.items()})


CHANNELS = {
    "lossy": lambda mod: lossy(cls=mod),
    "drop switch 2": lambda mod: (_drop_frag(2, base=mod, seed=4),),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("channels", sorted(CHANNELS))
@pytest.mark.parametrize("window", [4, 2])
def test_protocol_matches_reference_plane(backend, channels, window):
    """Windows of 4 (stage everything, then step) and of 2 with protocol
    rounds after each dispatch; the reference's plane gets the same
    windows through ``run_window``."""
    make = CHANNELS[channels]
    kw = dict(max_retries=2 if channels == "drop switch 2" else 12,
              steps_per_dispatch=3 if window == 2 else 0)
    plane = DurableExportPlane(build(backend), *make(LossyChannel), **kw)
    ref = _ref_plane(make(RChannel), **kw)
    for e0 in range(0, 4, window):
        plane.run_window(e0, STREAMS[e0:e0 + window])
        ref.run_window(e0, R_STREAMS[e0:e0 + window])
        assert _protocol(plane) == _protocol(ref)
    for _ in range(4):
        plane.step()
        ref.step()
        assert _protocol(plane) == _protocol(ref)
    assert plane.drain() == ref.drain()
    assert _protocol(plane) == _protocol(ref)
    if channels == "drop switch 2":
        assert plane.lost_cells() == {(2, e) for e in EPOCHS}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("ckpt_every", [0, 2])
def test_crash_reports_match_reference_plane(backend, ckpt_every, tmp_path):
    """The crash schedule of the reference's crash test, with and without
    auto-checkpoints: the same ``crash()`` report and protocol state, and
    the same checkpoint steps on disk."""
    kw = dict(max_retries=12, ckpt_every=ckpt_every, ckpt_keep=2)
    plane = DurableExportPlane(build(backend), *lossy(seed=21),
                               ckpt_dir=str(tmp_path / "port"), **kw)
    ref = _ref_plane(lossy(seed=21, cls=RChannel),
                     ckpt_dir=str(tmp_path / "ref"), **kw)
    plane.run_window(0, STREAMS)
    got = _crash_run(plane)
    ref.run_window(0, R_STREAMS)
    want = _crash_run(ref)
    assert got == want
    assert _protocol(plane) == _protocol(ref)
    assert plane.drain() == ref.drain()
    assert _protocol(plane) == _protocol(ref)
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "ref"))
    # a second crash after the drain restores the last checkpoint again
    assert plane.crash() == ref.crash()
    assert plane.drain() == ref.drain()
    assert _protocol(plane) == _protocol(ref)


# -- cell parity with the reference's loop records ------------------------------------

FROZEN_NS = {0: 1, 1: 2, 2: 4, 3: 2}


def _frozen(system):
    system.control_external = True
    system.ns.update(FROZEN_NS)
    return system


@pytest.mark.parametrize("kind", ["cs", "cms"])
@pytest.mark.parametrize("crash", [False, True])
def test_drained_cells_equal_reference_records(kind, crash, tmp_path):
    """``ns`` frozen on every system: the port's fleet and loop planes and
    the reference's loop plane run the same window, then the same
    protocol (a crash between two checkpoints, or none).  Mid-way the
    masked queries agree; drained, every fleet cell equals the reference's
    loop record and every port loop record equals it too."""
    def ckpt(name):
        return dict(ckpt_dir=str(tmp_path / name), ckpt_every=3) \
            if crash else {}

    fleet = DurableExportPlane(_frozen(build("fleet", kind)),
                               *lossy(seed=41), max_retries=12,
                               **ckpt("fleet"))
    loop = DurableExportPlane(_frozen(build("loop", kind)),
                              *lossy(seed=41), max_retries=12, **ckpt("loop"))
    ref = RPlane(_frozen(RSystem(MEMS, kind, rho_target=5.0,
                                 log2_te=LOG2_TE, backend="loop")),
                 *lossy(seed=41, cls=RChannel), max_retries=12,
                 **ckpt("ref"))
    planes = (fleet, loop, ref)
    fleet.run_window(0, STREAMS)
    loop.run_window(0, STREAMS)
    ref.run_window(0, R_STREAMS)
    for _ in range(4):
        for p in planes:
            p.step()
    assert fleet.pending_cells() and \
        fleet.pending_cells() == ref.pending_cells()
    for failures in ("mask", "oblivious"):
        want = ref.query_flows(KEYS, PATHS, EPOCHS, failures=failures)
        np.testing.assert_array_equal(
            loop.query_flows(KEYS, PATHS, EPOCHS, failures=failures), want)
        if failures == "mask":
            np.testing.assert_allclose(fleet.query_flows(
                KEYS, PATHS, EPOCHS, merge="fragment", failures=failures),
                ref.query_flows(KEYS, PATHS, EPOCHS, merge="fragment",
                                failures=failures), rtol=1e-6)
    if crash:
        reports = [p.crash() for p in planes]
        assert reports[0] == reports[1] == reports[2]
        assert reports[0]["restored_step"] is not None
    for p in planes:
        p.drain()
    assert fleet.lost_cells() == set() and not fleet.fleet._unexported
    assert fleet.stats() == loop.stats() == ref.stats()
    fl = fleet.fleet
    for e in EPOCHS:
        for sw in range(SW):
            rec = ref.records[e][sw]
            assert rec.n == FROZEN_NS[sw]
            cell = fl.cell_counters(e, sw)
            np.testing.assert_array_equal(cell[0], rec.counters)
            np.testing.assert_array_equal(loop.records[e][sw].counters,
                                          rec.counters)
    for merge in ("fragment", "subepoch"):
        for failures in ("mask", "oblivious"):
            want = ref.query_flows(KEYS, PATHS, EPOCHS, merge=merge,
                                   failures=failures)
            np.testing.assert_array_equal(loop.query_flows(
                KEYS, PATHS, EPOCHS, merge=merge, failures=failures), want)
            np.testing.assert_allclose(fleet.query_flows(
                KEYS, PATHS, EPOCHS, merge=merge, failures=failures), want,
                rtol=1e-6)
