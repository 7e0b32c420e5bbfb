"""The port's spine-leaf fabric and ``Workload.duration`` against the JAX
package's.

``SpineLeaf.paths`` must give the reference's paths on seeded hosts and
keys; a small ``SpineLeaf`` trace replayed per epoch through the port's
fleet backend on the CPU must give records and ``n_log`` bit-identical to
the reference's loop backend, and ``query_flows`` under both merges equal
to it (per-epoch runs keep nothing on the device, so the record plane,
host numpy in both packages, answers).
"""
import numpy as np
import pytest

from repro.core.disketch import DiSketchSystem as RSystem
from repro.net.simulator import Replayer as RReplayer
from repro.net.topology import FatTree as RFatTree
from repro.net.topology import SpineLeaf as RSpineLeaf
from repro.net.traffic import gen_workload as r_gen_workload
from repro_torch.core.disketch import DiSketchSystem
from repro_torch.net.simulator import Replayer
from repro_torch.net.topology import FatTree, SpineLeaf
from repro_torch.net.traffic import gen_workload
from torch_threads import one_thread  # noqa: F401

LOG2_TE = 12
N_EPOCHS = 4
WL_KW = dict(n_flows=1500, total_packets=15_000, n_epochs=N_EPOCHS,
             log2_te=LOG2_TE, burstiness=0.2, seed=3)


@pytest.mark.parametrize("shape", [(8, 4, 4), (4, 3, 2), (16, 8, 8)])
def test_spineleaf_paths_match_reference(shape):
    n_leaves, n_spines, hosts = shape
    topo = SpineLeaf(n_leaves, n_spines, hosts)
    ref = RSpineLeaf(n_leaves, n_spines, hosts)
    assert (topo.name, topo.n_switches, topo.n_hosts, topo.core_ids) == \
        (ref.name, ref.n_switches, ref.n_hosts, ref.core_ids)
    rng = np.random.default_rng(sum(shape))
    src = rng.integers(0, topo.n_hosts, 5000)
    dst = rng.integers(0, topo.n_hosts, 5000)
    keys = rng.integers(0, 2 ** 32, 5000, dtype=np.uint64).astype(np.uint32)
    got = topo.paths(src, dst, keys)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, ref.paths(src, dst, keys))
    lengths = set((got >= 0).sum(axis=1).tolist())
    assert lengths == {1, 3}
    spines = got[:, 1][got[:, 1] >= 0]
    assert set(spines.tolist()) == set(topo.core_ids)


@pytest.mark.parametrize("topo_name", ["fattree", "spineleaf"])
def test_workload_duration_matches_reference(topo_name):
    port_topo, ref_topo = ((FatTree(4), RFatTree(4)) if topo_name ==
                           "fattree" else (SpineLeaf(), RSpineLeaf()))
    kw = dict(n_flows=300, total_packets=3000, n_epochs=5, log2_te=9,
              seed=2)
    wl, rwl = gen_workload(port_topo, **kw), r_gen_workload(ref_topo, **kw)
    assert isinstance(wl.duration, int)
    assert wl.duration == rwl.duration == 5 << 9
    np.testing.assert_array_equal(wl.path_mat, rwl.path_mat)
    assert wl.pkt_ts.max() < wl.duration


@pytest.fixture(scope="module")
def spineleaf():
    topo = SpineLeaf()
    wl = gen_workload(topo, **WL_KW)
    rwl = r_gen_workload(RSpineLeaf(), **WL_KW)
    np.testing.assert_array_equal(wl.path_mat, rwl.path_mat)
    mems = {sw: 2 * 1024 + 512 * sw for sw in range(topo.n_switches)}
    return dict(wl=wl, rep=Replayer(wl, topo.n_switches),
                rrep=RReplayer(rwl, topo.n_switches), mems=mems)


# kind, rho_target (one that moves the Eq. 6 control at this load), the
# fragment keywords
CASES = {"cs": ("cs", 2.0, {}), "cms": ("cms", 0.2, {}),
         "um4": ("um", 2.0, dict(n_levels=4))}


@pytest.mark.parametrize("name", sorted(CASES))
def test_spineleaf_per_epoch_matches_reference(spineleaf, name):
    kind, rho, cfg_kw = CASES[name]
    sc = spineleaf
    ref = RSystem(sc["mems"], kind, rho_target=rho, log2_te=LOG2_TE,
                  backend="loop", **cfg_kw)
    sc["rrep"].run(ref)
    port = DiSketchSystem(sc["mems"], kind, rho_target=rho,
                          log2_te=LOG2_TE, device="cpu", **cfg_kw)
    sc["rep"].run(port)
    assert port.n_log == ref.n_log
    assert max(max(n.values()) for n in ref.n_log) > 1   # control moved
    for e in range(N_EPOCHS):
        assert set(port.records[e]) == set(ref.records[e])
        for sw in sc["mems"]:
            got, want = port.records[e][sw], ref.records[e][sw]
            assert got.n == want.n
            np.testing.assert_array_equal(got.counters, want.counters)
    wl = sc["wl"]
    sel = np.flatnonzero(wl.path_len >= 1)[:400]
    keys = wl.keys[sel]
    paths = [wl.paths[i] for i in sel]
    assert {len(p) for p in paths} == {1, 3}
    epochs = list(range(N_EPOCHS))
    for merge in ("subepoch", "fragment"):
        np.testing.assert_array_equal(
            port.query_flows(keys, paths, epochs, merge=merge),
            ref.query_flows(keys, paths, epochs, merge=merge))


def test_spineleaf_runs():
    """The reference's ``tests/test_system.py::test_spineleaf_runs`` on the
    port: a cms DiSketch on the spine-leaf fabric tracks the 3-hop flows'
    true sizes."""
    topo = SpineLeaf()
    wl = gen_workload(topo, n_flows=2000, total_packets=20000, n_epochs=4,
                      seed=3)
    rep = Replayer(wl, topo.n_switches)
    mems = {sw: 4 * 1024 for sw in range(topo.n_switches)}
    sysd = DiSketchSystem(mems, "cms", rho_target=10.0,
                          log2_te=wl.log2_te, device="cpu")
    rep.run(sysd)
    sel = wl.path_len == 3
    est = sysd.query_flows(wl.keys[sel],
                           [p for p, s in zip(wl.paths, sel) if s],
                           list(range(wl.n_epochs)))
    assert np.corrcoef(est, wl.sizes[sel])[0, 1] > 0.8
