"""The port's sharded fleet (``DiSketchSystem(..., mesh=...)``) against the
port's single-device fleet, on the CPU.

The mesh is ``make_switch_mesh(n, devices=["cpu"] * n)``: n shards that
each pack, dispatch and keep their own fragments' rows, and a query that
copies only the gathered ``(E, R_g, K)`` estimate slices to the merge
device.  The reference's own oracle for its sharded fleet is its
single-device fleet (``tests/test_fleet_sharded.py``, whose fleet cases
cannot run under this jax); the port's single-device fleet is held to the
reference by the other ``test_torch_*`` files.  So every comparison here
is ``array_equal`` or ``==``, never allclose:

* the reference's seven sharded tests carried over at the same fleet
  (6 switches, memories 2048 and 4096, ``log2_te = 12``, the same
  streams), with a one-shard mesh beside 2, 4 and 8;
* the bytes that cross shards at query time: only the ``(E, R_g, K)`` f32
  estimate slices pass through ``engine._all_gather_rows``;
* the control, export and chaos planes over a two-shard fleet under the
  settings of ``tests/test_torch_chaos.py``, and ``Replayer.run`` with
  churn inside windows and shard-local parity groups;
* the layout held to the reference's own code: ``shard_frag_bounds`` and
  the ``"shard-local"`` parity refusal;
* no quiet repetition: ``make_switch_mesh(n)`` raises without n cards.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core.disketch import DiSketchSystem, SwitchStream
from repro_torch.core.fleet import FleetEpochRunner, parity_groups_chunked
from repro_torch.kernels.sketch_query import engine as TE
from repro_torch.launch import make_switch_mesh, shard_frag_bounds
from repro_torch.net import simulator as TS
from repro_torch.net.channel import LossyChannel
from repro_torch.net.topology import FatTree
from repro_torch.net.traffic import gen_workload
from repro_torch.runtime import (ChaosHarness, DurableExportPlane,
                                 VersionedControlPlane, cells_equal)
from torch_threads import one_thread  # noqa: F401

N_SW = 6
MEMS = {sw: 4096 if sw % 2 else 2048 for sw in range(N_SW)}
PATH = (0, 2, 4)
KEYS = np.arange(0, 500, 7, dtype=np.uint32)
EPOCHS = [0, 1, 2]


def _streams(e, n_sw=N_SW, skew=1):
    out = {}
    for sw in range(n_sw):
        n = 150 + skew * 40 * sw + 10 * e
        r = np.random.default_rng(100 * e + sw)
        out[sw] = SwitchStream(
            r.integers(0, 500, n).astype(np.uint32),
            r.integers(1, 5, n).astype(np.int64),
            r.integers(0, 1 << 12, n).astype(np.int64),
            single_hop=r.random(n) < 0.3)
    return out


def cpu_mesh(n):
    return make_switch_mesh(n, devices=["cpu"] * n)


def _system(kind, mesh, mems=MEMS, rho=2.0, log2_te=12, **kw):
    where = dict(device="cpu") if mesh is None else dict(mesh=mesh)
    return DiSketchSystem(mems, kind, rho_target=rho, log2_te=log2_te,
                          backend="fleet", **where, **kw)


def _pair(kind, n_dev, **kw):
    mesh = cpu_mesh(n_dev)
    assert mesh.shape == {"switch": n_dev}
    return _system(kind, None, **kw), _system(kind, mesh, **kw)


def _run_both(ref, sh, e_count=3, **kw):
    for s in (ref, sh):
        s.run_window(0, [_streams(e) for e in range(e_count)], **kw)


def _host_stack(fleet, epoch):
    """The epoch's unpadded ``(R, n_sub_max, width_max)`` counters on the
    host (the reference's ``_host_stack``), from the resident groups."""
    buf, e_idx = fleet._window_bufs[epoch]
    assert buf.resident, "a window left the device"
    return buf.dense_host()[e_idx]


def assert_shard_local(fleet):
    """Every retained row group holds rows of one shard only, on that
    shard's device, and an empty shard holds nothing."""
    L = fleet.n_levels
    owner = np.empty(len(fleet.frag_order), np.int64)
    for s, (lo, hi) in enumerate(fleet._shard_frag_bounds):
        owner[lo:hi] = s
    for buf, _ in fleet._window_bufs.values():
        for rows, c in buf.device() or ():
            shards = set(owner[np.asarray(rows) // L].tolist())
            assert len(shards) == 1, shards
            assert c.device == fleet.mesh.devices[shards.pop()]


def assert_cells_equal(ref, sh, epochs):
    for e in epochs:
        for sw in ref.fleet.frag_order:
            assert np.array_equal(ref.fleet.cell_counters(e, sw),
                                  sh.fleet.cell_counters(e, sw)), (e, sw)
        assert np.array_equal(_host_stack(ref.fleet, e),
                              _host_stack(sh.fleet, e))


# -- the reference's tests/test_fleet_sharded.py, on the port -----------------

@pytest.mark.parametrize("kind", ["cms", "cs"])
@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_counters_and_queries_bit_identical(kind, n_dev):
    ref, sh = _pair(kind, n_dev)
    _run_both(ref, sh)
    assert_shard_local(sh.fleet)
    # heterogeneous widths (2048/4096 memories) and, after the window,
    # heterogeneous ns from the §4.2 control: both fleets saw the same
    # PEBs, so their control trajectories agree too
    assert ref.ns == sh.ns and ref.peb_log == sh.peb_log
    paths = [PATH] * len(KEYS)
    a = ref.query_flows(KEYS, paths, EPOCHS, merge="fragment")
    b = sh.query_flows(KEYS, paths, EPOCHS, merge="fragment")
    assert np.array_equal(a, b)
    # a single-hop path group goes through the §4.4 mitigation plumbing
    a1 = ref.query_flows(KEYS, [(3,)] * len(KEYS), EPOCHS, merge="fragment")
    b1 = sh.query_flows(KEYS, [(3,)] * len(KEYS), EPOCHS, merge="fragment")
    assert np.array_equal(a1, b1)
    assert_cells_equal(ref, sh, EPOCHS)
    # the next window runs at the controlled ns, shard by shard
    for s in (ref, sh):
        s.run_window(3, [_streams(e) for e in range(3, 6)])
    assert ref.n_log == sh.n_log
    assert np.array_equal(
        ref.query_flows(KEYS, paths, range(6), merge="fragment"),
        sh.query_flows(KEYS, paths, range(6), merge="fragment"))
    assert_cells_equal(ref, sh, range(3, 6))


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_um_levels_and_entropy_bit_identical(n_dev):
    ref, sh = _pair("um", n_dev, n_levels=4)
    _run_both(ref, sh)
    assert_shard_local(sh.fleet)
    paths = [PATH] * len(KEYS)
    a = ref.fleet.um_level_window_query(EPOCHS, KEYS, path=PATH)
    b = sh.fleet.um_level_window_query(EPOCHS, KEYS, path=PATH)
    assert np.array_equal(a, b)
    ea = ref.query_entropy(KEYS, paths, EPOCHS, total=1e4, n_levels=4,
                           merge="fragment")
    eb = sh.query_entropy(KEYS, paths, EPOCHS, total=1e4, n_levels=4,
                          merge="fragment")
    assert ea == eb
    fa = ref.query_flows(KEYS, paths, EPOCHS, merge="fragment")
    fb = sh.query_flows(KEYS, paths, EPOCHS, merge="fragment")
    assert np.array_equal(fa, fb)
    assert_cells_equal(ref, sh, EPOCHS)


def test_churn_mask_parity_and_blind_raise():
    # a fail inside the window: switch 2 dead from epoch 1, its epoch-0
    # cell lost, on both fleets; masked queries stay bit-identical, and a
    # path whose every fragment is out raises on both
    ev = [(), [SimpleNamespace(kind="fail", switch=2, factor=1.0)], ()]
    ref, sh = _pair("cms", 4)
    _run_both(ref, sh, events_by_epoch=ev)
    paths = [PATH] * len(KEYS)
    for failures in ("mask", "oblivious"):
        a = ref.query_flows(KEYS, paths, EPOCHS, merge="fragment",
                            failures=failures)
        b = sh.query_flows(KEYS, paths, EPOCHS, merge="fragment",
                           failures=failures)
        assert np.array_equal(a, b)
        assert ref.last_observability == sh.last_observability
    assert sh.last_observability["scale"] == 1.0
    assert ref.fleet._lost == sh.fleet._lost == {0: {2}}
    for s in (ref, sh):
        with pytest.raises(ValueError, match="unobservable"):
            s.fleet.window_query([1, 2], KEYS[:4], path=(2,),
                                 failures="mask")
    assert_cells_equal(ref, sh, EPOCHS)


def test_parity_recovery_shard_local():
    # 6 fragments over 2 shards: shard-local groups of 3; a lost cell
    # reconstructs bit-identically on the sharded fleet
    groups = [[0, 1, 2], [3, 4, 5]]
    ev = [(), (), [SimpleNamespace(kind="fail", switch=4, factor=1.0)]]
    ref, sh = _pair("cms", 2, fleet_kwargs={"parity_groups": groups})
    _run_both(ref, sh, events_by_epoch=ev)
    assert ref.fleet.recoverable() == sh.fleet.recoverable() \
        == {0: [4], 1: [4]}
    for e in (0, 1):
        for a, b in zip(ref.fleet._parity[e], sh.fleet._parity[e]):
            assert torch.equal(a, b)
    assert ref.fleet.recover() == sh.fleet.recover()
    a = ref.query_flows(KEYS, [PATH] * len(KEYS), EPOCHS, merge="fragment")
    b = sh.query_flows(KEYS, [PATH] * len(KEYS), EPOCHS, merge="fragment")
    assert np.array_equal(a, b)
    assert_cells_equal(ref, sh, EPOCHS)


def test_parity_group_spanning_shards_rejected():
    frags = _system("cms", None).fragments
    with pytest.raises(ValueError, match="shard-local"):
        FleetEpochRunner(frags, 12, mesh=cpu_mesh(2),
                         parity_groups=[[2, 3]])  # spans shards 0 and 1
    # the same group is shard-local over one shard
    FleetEpochRunner(frags, 12, mesh=cpu_mesh(1), parity_groups=[[2, 3]])


def test_run_epoch_mesh_matches():
    ref, sh = _pair("cs", 4, fleet_kwargs={"keep_stacked": True})
    for s in (ref, sh):
        s.run_epoch(0, _streams(0))
        s.run_epoch(1, _streams(1), events=[
            SimpleNamespace(kind="fail", switch=1, factor=1.0)])
    for e in (0, 1):
        assert set(ref.records[e]) == set(sh.records[e])
        for sw in ref.records[e]:
            assert np.array_equal(ref.records[e][sw].counters,
                                  sh.records[e][sw].counters)
    assert set(sh.records[1]) == set(range(N_SW)) - {1}
    assert ref.peb_log == sh.peb_log and ref.n_log == sh.n_log
    # keep_stacked registers the cross-shard groups as one-epoch windows
    assert_shard_local(sh.fleet)
    assert_cells_equal(ref, sh, (0, 1))
    paths = [PATH] * len(KEYS)
    assert np.array_equal(
        ref.query_flows(KEYS, paths, [0, 1], merge="fragment"),
        sh.query_flows(KEYS, paths, [0, 1], merge="fragment"))


def test_mesh_requires_fleet_backend_and_switch_axis():
    with pytest.raises(ValueError, match="backend='fleet'"):
        DiSketchSystem(MEMS, "cms", 2.0, 12, backend="loop",
                       mesh=cpu_mesh(2))
    frags = _system("cms", None).fragments
    # every port mesh has the one "switch" axis; the runner shards over it
    runner = FleetEpochRunner(frags, 12, mesh=cpu_mesh(2))
    assert runner.n_shards == cpu_mesh(2).shape["switch"] == 2
    with pytest.raises(ValueError, match="ragged"):
        FleetEpochRunner(frags, 12, mesh=cpu_mesh(2), layout="dense")
    with pytest.raises(ValueError, match="not both"):
        FleetEpochRunner(frags, 12, mesh=cpu_mesh(2), device="cpu")
    with pytest.raises(ValueError, match="not both"):
        _system("cms", cpu_mesh(2), device="cpu")


# -- what crosses shards ------------------------------------------------------

@pytest.mark.parametrize("kind", ["cs", "um"])
def test_only_estimate_slices_cross_shards(kind, monkeypatch):
    """Every tensor that reaches the merge device from a shard is a
    gathered ``(E, R_g, K)`` f32 estimate slice, one per row group that a
    query needs; no counter group passes."""
    kw = dict(n_levels=4) if kind == "um" else {}
    ref, sh = _pair(kind, 4, **kw)
    _run_both(ref, sh)
    moved, copy = [], TE._all_gather_rows

    def watch(part, dev):
        moved.append((tuple(part.shape), part.dtype))
        return copy(part, dev)

    monkeypatch.setattr(TE, "_all_gather_rows", watch)
    paths = [PATH] * len(KEYS)
    est = sh.query_flows(KEYS, paths, EPOCHS, merge="fragment")
    groups = [g for buf, _ in {id(b): (b, 0) for b, _ in
                               sh.fleet._window_bufs.values()}.values()
              for g in buf.device()]
    L = sh.fleet.n_levels
    on_path = {sh.fleet.frag_order.index(sw) for sw in PATH}
    # the frequency query reads the on-path level-0 rows
    n_need = [sum(int(r) // L in on_path and int(r) % L == 0 for r in rows)
              for rows, _ in groups]
    want = sorted((len(EPOCHS), n, len(KEYS)) for n in n_need if n)
    assert sorted(s for s, _ in moved) == want
    assert all(dt == torch.float32 for _, dt in moved)
    counter_shapes = {tuple(c.shape) for _, c in groups}
    assert not counter_shapes & {s for s, _ in moved}
    assert np.array_equal(
        est, ref.query_flows(KEYS, paths, EPOCHS, merge="fragment"))
    if kind == "um":
        moved.clear()
        sh.fleet.um_level_window_query(EPOCHS, KEYS)
        assert sorted(s for s, _ in moved) == sorted(
            (len(EPOCHS), len(rows), len(KEYS)) for rows, _ in groups)
    # the bytes moved are the estimate slices' alone, far below the
    # resident counters'
    moved_bytes = sum(4 * int(np.prod(s)) for s, _ in moved)
    resident = sum(c.numel() * 4 for _, c in groups)
    assert 0 < moved_bytes < resident


# -- the planes over a sharded fleet ------------------------------------------

WL_KW = dict(n_flows=400, total_packets=6_000, n_epochs=6, burstiness=0.2,
             seed=13)
WL = gen_workload(FatTree(4), **WL_KW)
WL_MEMS = {sw: 256 for sw in range(20)}


def _chaos_stack(system):
    export = DurableExportPlane(
        system, LossyChannel(p_drop=0.2, p_dup=0.1, p_reorder=0.2,
                             delay=(0, 2), seed=60),
        LossyChannel(p_drop=0.1, p_dup=0.1, delay=(0, 1), seed=61),
        max_retries=12, steps_per_dispatch=0)
    control = VersionedControlPlane(
        export, LossyChannel(p_drop=0.5, p_dup=0.1, p_reorder=0.3,
                             delay=(0, 1), seed=62),
        LossyChannel(p_drop=0.25, p_dup=0.1, delay=(0, 1), seed=63))
    return ChaosHarness(control, steps_per_dispatch=6, crash_every=2)


def _chaos_schedule():
    churn = TS.FailureSchedule(20, downs={3: (2, 4), 9: (3, None)})
    pressure = TS.ResourcePressure(20, horizon=6, seed=21, p_grab=0.3)
    return TS.ComposedSchedule([churn, pressure])


def test_planes_over_sharded_fleet_match_single_device():
    """Control over export over a two-shard cs fleet, windows of 2 under
    churn, resource pressure, lossy channels and collector crashes: the
    same report, crash log, applied and lost cells, control logs and
    ``"mask"`` query as over the single-device fleet."""
    mesh = cpu_mesh(2)
    build = {
        "one": lambda: _system("cs", None, WL_MEMS, 0.05, WL.log2_te),
        "two": lambda: _system("cs", mesh, WL_MEMS, 0.05, WL.log2_te)}
    hs = {}
    for name, make in build.items():
        h = hs[name] = _chaos_stack(make())
        TS.Replayer(WL, 20).run(h, window=2, failures=_chaos_schedule())
        h.report = h.finish()
        assert h.verify_config_twin(make) == h.report["applied"] > 0
    one, two = hs["one"], hs["two"]
    assert_shard_local(two.system.fleet)
    assert one.report == two.report
    assert one.report["crashes"] >= 1 and one.report["lost"] == []
    assert one.crash_log == two.crash_log
    assert one.staged == two.staged
    applied = one.export.collector.applied
    assert applied == two.export.collector.applied
    assert cells_equal(one.system, two.system, sorted(applied))
    assert one.control.applied_log == two.control.applied_log
    assert one.control.clamp_log == two.control.clamp_log
    assert one.system.n_log == two.system.n_log
    keys, paths = WL.keys[:30], [WL.paths[i] for i in range(30)]
    a = one.query_flows(keys, paths, range(6), merge="fragment",
                        failures="mask")
    b = two.query_flows(keys, paths, range(6), merge="fragment",
                        failures="mask")
    assert np.array_equal(a, b)
    assert one.last_observability == two.last_observability


@pytest.mark.parametrize("kind,n_dev", [("cs", 2), ("cms", 4), ("um", 8)])
def test_replayer_churn_windows_bit_identical(kind, n_dev):
    """``Replayer.run(window=3)`` with deaths inside windows, resource
    pressure and shard-local parity groups: the same trajectory, dead,
    lost and recoverable cells, every cell, and the queries under every
    policy, "recover" last (it patches the windows in place)."""
    groups = parity_groups_chunked(range(20), -(-20 // n_dev))
    kw = dict(n_levels=4) if kind == "um" else {}
    systems = []
    for mesh in (None, cpu_mesh(n_dev)):
        s = _system(kind, mesh, WL_MEMS, 0.05, WL.log2_te,
                    fleet_kwargs={"parity_groups": groups}, **kw)
        sched = TS.ComposedSchedule([
            TS.FailureSchedule(20, downs={3: (1, 4), 4: (2, 3),
                                          12: (4, 5)}),
            TS.ResourcePressure(20, horizon=6, seed=5)])
        TS.Replayer(WL, 20).run(s, window=3, failures=sched)
        systems.append(s)
    ref, sh = systems
    assert_shard_local(sh.fleet)
    assert ref.n_log == sh.n_log and ref._dead_at == sh._dead_at
    assert ref.fleet._lost == sh.fleet._lost and ref.fleet._lost
    assert ref.fleet.recoverable() == sh.fleet.recoverable()
    assert_cells_equal(ref, sh, range(6))
    keys, paths = WL.keys[:60], [WL.paths[i] for i in range(60)]
    for failures in ("oblivious", "mask", "recover"):
        a = ref.query_flows(keys, paths, range(6), merge="fragment",
                            failures=failures)
        b = sh.query_flows(keys, paths, range(6), merge="fragment",
                           failures=failures)
        assert np.array_equal(a, b), failures
        assert ref.last_observability == sh.last_observability
    assert_cells_equal(ref, sh, range(6))
    if kind == "um":
        assert ref.query_entropy(keys, paths, range(6), 6e3, n_levels=4,
                                 merge="fragment") == \
            sh.query_entropy(keys, paths, range(6), 6e3, n_levels=4,
                             merge="fragment")


# -- the layout, held to the reference's own code -----------------------------

def test_layout_matches_reference(multidevice):
    """``shard_frag_bounds`` for 1..25 fragments over 1..8 shards, and the
    ``"shard-local"`` refusal, are the reference runner's (built in this
    process on the forced 8-device CPU mesh, as its own constructor tests
    do)."""
    from repro.core.fleet import FleetEpochRunner as RRunner
    from repro.core.fragment import FragmentConfig as RCfg
    from repro.launch.mesh import make_switch_mesh as r_make_mesh

    r_meshes = {n: r_make_mesh(n) for n in range(1, 9)}
    for f in range(1, 26):
        frags = {sw: RCfg(frag_id=sw, kind="cms", memory_bytes=2048)
                 for sw in range(f)}
        for n in range(1, 9):
            ref = RRunner(frags, 12, mesh=r_meshes[n])
            assert shard_frag_bounds(f, n) == ref._shard_frag_bounds
    t_frags = _system("cms", None, {sw: 2048 for sw in range(11)}).fragments
    r_frags = {sw: RCfg(frag_id=sw, kind="cms", memory_bytes=2048)
               for sw in range(11)}
    for n in (2, 3, 4, 8):
        for groups in ([[i, j]] for i in range(11) for j in range(i + 1, 11)):
            refused = []
            for build in (
                    lambda: RRunner(r_frags, 12, mesh=r_meshes[n],
                                    parity_groups=groups),
                    lambda: FleetEpochRunner(t_frags, 12, mesh=cpu_mesh(n),
                                             parity_groups=groups)):
                try:
                    build()
                    refused.append(False)
                except ValueError as e:
                    assert "shard-local" in str(e)
                    refused.append(True)
            assert refused[0] == refused[1], (n, groups, refused)


def test_make_switch_mesh_does_not_repeat_quietly():
    have = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="CUDA device"):
        make_switch_mesh(have + 1)
    if not have:
        with pytest.raises(RuntimeError, match="CUDA device"):
            make_switch_mesh()
    # repetition only when the caller lists the devices
    mesh = make_switch_mesh(devices=["cpu"] * 3)
    assert mesh.shape == {"switch": 3}
    with pytest.raises(ValueError, match="devices listed"):
        make_switch_mesh(2, devices=["cpu"] * 3)
