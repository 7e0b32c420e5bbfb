"""The host copy of a resident window, made row group by row group.

A window holds one narrow fragment at n = 256 beside wide fragments at
n = 1.  Touching a record copies the window to the host; the copy must be
the row groups themselves (one int64 array each), not a stack padded to
the window's ``(n_sub_max, width_max)``: its bytes, read from the buffer,
stay within 1.1x of the sum of the group sizes.  The records must equal
the reference's loop records under the same frozen ``ns``, and the default
``query_flows`` (subepoch merge, on the records) the reference's.  After
the copy, the fleet's host query branch answers from the groups, as the
device did before it.
"""
import numpy as np
import pytest

from repro.core.disketch import DiSketchSystem as RDiSketch
from repro.core.disketch import SwitchStream as RStream
from repro.core.fragment import FragmentConfig as RCfg
from repro.core.fragment import process_epoch
from repro.net.simulator import Replayer as RReplayer
from repro.net.topology import FatTree as RFatTree
from repro.net.traffic import gen_workload as r_gen_workload
from repro_torch.core.disketch import DiSketchSystem
from repro_torch.net.simulator import Replayer
from repro_torch.net.topology import FatTree
from repro_torch.net.traffic import gen_workload

LOG2_TE = 12
WINDOW = 4
NARROW = 3                      # the switch whose fragment runs at n = 256
WL_KW = dict(n_flows=2000, total_packets=30_000, n_epochs=WINDOW,
             log2_te=LOG2_TE, burstiness=0.2, seed=5)


def _memories():
    mems = {sw: 64 * 1024 for sw in range(20)}
    mems[NARROW] = 4 * 1024
    return mems


@pytest.fixture(scope="module")
def reference():
    wl = r_gen_workload(RFatTree(4), **WL_KW)
    return wl, RReplayer(wl, 20)


def _reference_records(rep, mems, kind, ns, cfg_kw):
    frags = {sw: RCfg(sw, kind, m, **cfg_kw) for sw, m in mems.items()}
    empty = RStream(np.zeros(0, np.uint32), np.zeros(0, np.int64),
                    np.zeros(0, np.int64))
    records = {}
    for e in range(WINDOW):
        records[e] = {}
        for sw, cfg in frags.items():
            st = rep.epoch_stream(e).get(sw, empty)
            records[e][sw] = process_epoch(cfg, e, ns[sw], st.keys,
                                           st.values, st.ts, e << LOG2_TE,
                                           LOG2_TE, single_hop=st.single_hop)
    return records


CASES = {"cs": ("cs", {}), "cms": ("cms", {}),
         "um4": ("um", dict(n_levels=4))}


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_host_copy_is_its_row_groups(reference, name):
    kind, cfg_kw = CASES[name]
    rwl, rrep = reference
    mems = _memories()
    system = DiSketchSystem(mems, kind, rho_target=2.0, log2_te=LOG2_TE,
                            device="cpu", **cfg_kw)
    system.ns[NARROW] = 256
    ns = dict(system.ns)
    wl = gen_workload(FatTree(4), **WL_KW)
    rep = Replayer(wl, 20)
    order = system.fleet.frag_order
    system.run_window(0, [rep.epoch_stream(e) for e in range(WINDOW)],
                      packets=[rep.epoch_packet(e, order)
                               for e in range(WINDOW)])
    fleet = system.fleet
    buf = fleet._window_bufs[0][0]
    groups = buf.device()
    assert sorted(c.shape[2] for _, c in groups) == [1, 256]
    group_bytes = sum(c.numel() * 8 for _, c in groups)     # as int64
    padded_bytes = int(np.prod(buf._shape)) * 8
    assert padded_bytes > 20 * group_bytes

    epochs = list(range(WINDOW))
    sel = wl.path_len >= 3
    keys, paths = wl.keys[sel], [p for p, s in zip(wl.paths, sel) if s]
    on_device = system.query_flows(keys, paths, epochs, merge="fragment")
    assert buf.host_bytes == 0 and buf._host is None

    ref_recs = _reference_records(rrep, mems, kind, ns, cfg_kw)
    for e in epochs:
        for sw in mems:
            rec = system.records[e][sw]
            assert rec.n == ref_recs[e][sw].n
            np.testing.assert_array_equal(rec.counters,
                                          ref_recs[e][sw].counters)
            # a view of its own group, not a copy
            assert any(np.shares_memory(rec.counters, c)
                       for _, c in buf.host())
    assert not buf.resident
    assert 0 < buf.host_bytes <= 1.1 * group_bytes
    assert buf.host_bytes == group_bytes

    ref = RDiSketch(mems, kind, rho_target=2.0, log2_te=LOG2_TE, **cfg_kw)
    ref.records = ref_recs
    np.testing.assert_allclose(system.query_flows(keys, paths, epochs),
                               ref.query_flows(keys, paths, epochs),
                               rtol=1e-12)
    # the host branch of the fleet query reads the groups, as the device
    # did before the copy
    assert not fleet.has_device_window(epochs)
    np.testing.assert_allclose(
        system.query_flows(keys, paths, epochs, merge="fragment"),
        on_device, rtol=1e-6, atol=1e-6)
    assert buf.host_bytes == group_bytes



def test_level_rows_out_of_level_order_are_copied():
    """Where a group lists a UnivMon fragment's level rows out of level
    order, each record is a copy of its own rows, in level order."""
    import torch

    from repro_torch.core.fleet import WindowRecords, _WindowBuffer

    mems = _memories()
    system = DiSketchSystem(mems, "um", rho_target=2.0, log2_te=LOG2_TE,
                            device="cpu", n_levels=4)
    system.ns[NARROW] = 256
    wl = gen_workload(FatTree(4), **WL_KW)
    rep = Replayer(wl, 20)
    fleet = system.fleet
    system.run_window(0, [rep.epoch_stream(e) for e in range(WINDOW)],
                      packets=[rep.epoch_packet(e, fleet.frag_order)
                               for e in range(WINDOW)])
    buf = fleet._window_bufs[0][0]
    # the same groups, each listing its rows backwards
    flipped = _WindowBuffer(
        [(np.ascontiguousarray(rows[::-1]), torch.flip(c, dims=[1]))
         for rows, c in buf.device()], buf._shape)
    # the window's frozen n (the records copy the buffer to the host)
    n_arr = np.array([system.records[0][sw].n for sw in fleet.frag_order])
    for e in range(WINDOW):
        got = WindowRecords(flipped, e, e, dict(fleet.fragments),
                            fleet.frag_order, n_arr, n_levels=4)
        for sw in mems:
            want = system.records[e][sw]
            assert got[sw].n == want.n
            np.testing.assert_array_equal(got[sw].counters, want.counters)
            assert not any(np.shares_memory(got[sw].counters, c)
                           for _, c in flipped.host())
