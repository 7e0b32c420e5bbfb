"""The per-epoch path of the port end to end on the CPU, against the JAX
package's loop backend.

``DiSketchSystem(device="cpu")`` (the fleet backend, ragged layout) and
``fleet_kwargs={"layout": "dense"}`` replay a small Fat-Tree workload with
``Replayer.run(system)``, which runs ``run_epoch`` epoch by epoch; the
reference is ``repro``'s ``DiSketchSystem(backend="loop")`` on the same
trace.  Records must be bit-identical (``array_equal``), the ``ns``
trajectories equal, PEBs within 1e-6 relative (f32 counters, float64
sums), and ``query_flows`` under both merges within 1e-6 relative (the
``docs/kernels.md`` §4 contract).  The port's loop backend, ``DiscoSystem``,
``calibrate_rho_target`` and the quickstart pipeline are held to the
reference the same way.
"""
import numpy as np
import pytest

from repro.core import disketch as RD
from repro.net.simulator import Replayer as RReplayer
from repro.net.simulator import rmse as r_rmse
from repro.net.topology import FatTree as RFatTree
from repro.net.traffic import cov_list as r_cov_list
from repro.net.traffic import gen_workload as r_gen_workload
from repro.net.traffic import gini_index as r_gini_index
from repro.net.traffic import gini_memories as r_gini_memories
from repro.net.traffic import linear_path_workload as r_linear
from repro_torch.core import disketch as TD
from repro_torch.net.simulator import Replayer, rmse
from repro_torch.net.topology import FatTree
from repro_torch.net.traffic import (cov_list, gen_workload, gini_index,
                                     linear_path_workload)
from torch_threads import one_thread  # noqa: F401

LOG2_TE = 12
N_EPOCHS = 8
WL_KW = dict(n_flows=3000, total_packets=40_000, n_epochs=N_EPOCHS,
             log2_te=LOG2_TE, burstiness=0.2, seed=1)
#: Flows queried per case: a seeded sample of the 5-hop and 1-hop flows
#: (the record plane runs one numpy merge per path group and epoch).
N_QUERY = 600


@pytest.fixture(scope="module")
def scenario():
    topo = RFatTree(4)
    wl = r_gen_workload(topo, **WL_KW)
    mems = r_gini_memories(topo.n_switches, 6 * 1024, 0.4,
                           np.random.RandomState(101))
    sel = np.flatnonzero((wl.path_len == 5) | (wl.path_len == 1))
    sel = np.sort(np.random.default_rng(0).choice(sel, N_QUERY,
                                                  replace=False))
    keys = wl.keys[sel]
    paths = [wl.paths[i] for i in sel]
    return dict(wl=wl, rep=RReplayer(wl, topo.n_switches),
                trep=Replayer(gen_workload(FatTree(4), **WL_KW),
                              topo.n_switches),
                mems={sw: int(m) for sw, m in enumerate(mems)},
                keys=keys, paths=paths, truth=wl.sizes[sel])


def _assert_same_run(port, ref, mems):
    assert port.n_log == ref.n_log
    for e in range(N_EPOCHS):
        assert set(port.records[e]) == set(ref.records[e])
        for sw in mems:
            got, want = port.records[e][sw], ref.records[e][sw]
            assert got.n == want.n and got.epoch == want.epoch
            assert got.counters.dtype == np.int64
            np.testing.assert_array_equal(got.counters, want.counters)
            assert port.peb_log[e][sw] == pytest.approx(ref.peb_log[e][sw],
                                                        rel=1e-6)


def _assert_same_queries(port, ref, sc):
    epochs = list(range(N_EPOCHS))
    for merge in ("subepoch", "fragment"):
        np.testing.assert_allclose(
            port.query_flows(sc["keys"], sc["paths"], epochs, merge=merge),
            ref.query_flows(sc["keys"], sc["paths"], epochs, merge=merge),
            rtol=1e-6, atol=1e-6)


EPOCH_CASES = {
    "cs": ("cs", {}, {}),
    "cms": ("cms", {}, {}),
    "um4": ("um", dict(n_levels=4), {}),
    "cs-mit": ("cs", dict(mitigation=True), {}),
    "cs-dense": ("cs", {}, dict(layout="dense")),
    "cms-dense": ("cms", {}, dict(layout="dense")),
}


@pytest.mark.parametrize("name", sorted(EPOCH_CASES))
def test_per_epoch_path_matches_reference(scenario, name):
    kind, cfg_kw, fleet_kw = EPOCH_CASES[name]
    sc = scenario
    ref = RD.DiSketchSystem(sc["mems"], kind, rho_target=2.0,
                            log2_te=LOG2_TE, backend="loop", **cfg_kw)
    sc["rep"].run(ref)
    port = TD.DiSketchSystem(sc["mems"], kind, rho_target=2.0,
                             log2_te=LOG2_TE, device="cpu",
                             fleet_kwargs=fleet_kw, **cfg_kw)
    assert port.backend == "fleet" and port.fleet.layout == \
        fleet_kw.get("layout", "ragged")
    sc["trep"].run(port)
    assert max(max(n.values()) for n in ref.n_log) > 1   # control moved
    _assert_same_run(port, ref, sc["mems"])
    # per-epoch runs keep nothing on the device: the record plane answers
    assert not port.fleet.has_device_window([0])
    _assert_same_queries(port, ref, sc)


def test_loop_backend_matches_reference(scenario):
    sc = scenario
    for kind, cfg_kw in (("cs", dict(mitigation=True)),
                         ("um", dict(n_levels=4))):
        ref = RD.DiSketchSystem(sc["mems"], kind, rho_target=2.0,
                                log2_te=LOG2_TE, backend="loop", **cfg_kw)
        sc["rep"].run(ref)
        port = TD.DiSketchSystem(sc["mems"], kind, rho_target=2.0,
                                 log2_te=LOG2_TE, backend="loop", **cfg_kw)
        assert port.fleet is None
        sc["trep"].run(port, window=4)     # no fleet: epoch by epoch
        _assert_same_run(port, ref, sc["mems"])
        np.testing.assert_allclose(
            port.query_flows(sc["keys"], sc["paths"], list(range(N_EPOCHS))),
            ref.query_flows(sc["keys"], sc["paths"], list(range(N_EPOCHS))),
            rtol=1e-6, atol=1e-6)


def test_disco_matches_reference(scenario):
    sc = scenario
    ref = RD.DiscoSystem(sc["mems"], "cs", rho_target=2.0, log2_te=LOG2_TE,
                         backend="loop")
    sc["rep"].run(ref)
    port = TD.DiscoSystem(sc["mems"], "cs", rho_target=2.0, log2_te=LOG2_TE,
                          device="cpu")
    sc["trep"].run(port)
    assert all(n == 1 for ns in port.n_log for n in ns.values())
    _assert_same_run(port, ref, sc["mems"])
    _assert_same_queries(port, ref, sc)
    # window mode runs DISCO at n = 1 too
    win = TD.DiscoSystem(sc["mems"], "cs", rho_target=2.0, log2_te=LOG2_TE,
                         device="cpu")
    sc["trep"].run(win, window=4)
    _assert_same_run(win, ref, sc["mems"])


def test_calibrate_rho_target_matches_reference(scenario):
    sc = scenario
    streams = sc["rep"].epoch_stream(N_EPOCHS // 2)
    for kind in ("cs", "cms"):
        want = RD.calibrate_rho_target(sc["mems"], kind, streams, LOG2_TE)
        for kw in (dict(device="cpu"), dict(backend="loop")):
            got = TD.calibrate_rho_target(sc["mems"], kind, streams, LOG2_TE,
                                          **kw)
            assert got == pytest.approx(want, rel=1e-6)


def test_keep_stacked_serves_point_queries(scenario):
    """``keep_stacked`` keeps each epoch's counters on the device, and
    point queries there equal the record plane's fragment merge; without
    it a per-epoch run retains nothing to query."""
    sc = scenario
    port = TD.DiSketchSystem(sc["mems"], "cs", rho_target=2.0,
                             log2_te=LOG2_TE, device="cpu",
                             fleet_kwargs=dict(keep_stacked=True))
    sc["trep"].run(port)
    epochs = list(range(N_EPOCHS))
    assert port.fleet.has_device_window(epochs)
    device = port.query_flows(sc["keys"], sc["paths"], epochs,
                              merge="fragment")
    host = TD.query.query_window
    path = sc["paths"][0]
    k = sc["keys"][[p == path for p in sc["paths"]]]
    recs = [[port.records[e][sw] for sw in path] for e in epochs]
    np.testing.assert_allclose(
        port.fleet.point_query(2, k, path=path),
        host([recs[2]], k, "cs", single_hop=np.full(len(k), len(path) == 1),
             merge="fragment"), rtol=1e-6, atol=1e-6)
    plain = TD.DiSketchSystem(sc["mems"], "cs", rho_target=2.0,
                              log2_te=LOG2_TE, device="cpu")
    sc["trep"].run(plain)
    np.testing.assert_allclose(
        plain.query_flows(sc["keys"], sc["paths"], epochs, merge="fragment"),
        device, rtol=1e-6, atol=1e-6)
    with pytest.raises(KeyError, match="keep_stacked"):
        plain.fleet.point_query(2, k, path=path)
    with pytest.raises(KeyError, match="no records"):
        plain.query_flows(k, [path] * len(k), [N_EPOCHS])


def test_quickstart_pipeline_matches_reference():
    """examples/quickstart.py at a small size: heterogeneous 5-hop path,
    calibrate, DiSketch against DISCO, on both packages."""
    rng = np.random.RandomState(0)
    widths = np.maximum(cov_list(5, 2048, 1.5, rng).astype(int), 4)
    rng_r = np.random.RandomState(0)
    np.testing.assert_array_equal(
        widths, np.maximum(r_cov_list(5, 2048, 1.5, rng_r).astype(int), 4))
    mems = {hop: int(w) * 4 for hop, w in enumerate(widths)}
    loads = np.maximum(cov_list(5, 40_000, 0.9, rng).astype(int), 16)
    kw = dict(eval_flows=120, eval_packets=1000, bg_packets_per_hop=loads,
              n_epochs=6, log2_te=LOG2_TE, seed=1)
    wl = linear_path_workload(5, **kw)
    rwl = r_linear(5, **kw)
    for f in ("keys", "sizes", "path_mat", "pkt_flow", "pkt_ts"):
        np.testing.assert_array_equal(getattr(wl, f), getattr(rwl, f))
    rep, rrep = Replayer(wl, 5), RReplayer(rwl, 5)
    rho = TD.calibrate_rho_target(mems, "cs", rep.epoch_stream(3), LOG2_TE,
                                  device="cpu")
    assert rho == pytest.approx(RD.calibrate_rho_target(
        mems, "cs", rrep.epoch_stream(3), LOG2_TE), rel=1e-6)
    sel = wl.path_len == 5
    keys, truth = wl.keys[sel], wl.sizes[sel]
    paths = [tuple(range(5))] * len(keys)
    epochs = list(range(6))
    for t_cls, r_cls in ((TD.DiSketchSystem, RD.DiSketchSystem),
                         (TD.DiscoSystem, RD.DiscoSystem)):
        port = t_cls(mems, "cs", rho_target=rho, log2_te=LOG2_TE,
                     device="cpu")
        rep.run(port)
        ref = r_cls(mems, "cs", rho_target=rho, log2_te=LOG2_TE)
        rrep.run(ref)
        assert port.n_log == ref.n_log
        est = port.query_flows(keys, paths, epochs)
        want = ref.query_flows(keys, paths, epochs)
        np.testing.assert_allclose(est, want, rtol=1e-6, atol=1e-6)
        assert rmse(est, truth) == pytest.approx(r_rmse(want, truth),
                                                 rel=1e-6)


def test_heterogeneity_generators_match_reference():
    for cov in (0.0, 0.5, 1.5):
        np.testing.assert_array_equal(
            cov_list(7, 1000.0, cov, np.random.RandomState(3)),
            r_cov_list(7, 1000.0, cov, np.random.RandomState(3)))
    x = np.random.default_rng(0).lognormal(size=50)
    assert gini_index(x) == r_gini_index(x)
    assert gini_index(np.zeros(3)) == 0.0


def test_default_backend_is_the_fleet_on_the_card():
    """A bare DiSketchSystem is the fleet backend on ``cuda``: without a
    card it raises instead of falling back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TD.DiSketchSystem({0: 4096}, "cs", rho_target=1.0, log2_te=LOG2_TE)
    assert TD.DiSketchSystem({0: 4096}, "cs", rho_target=1.0,
                             log2_te=LOG2_TE, device="cpu").backend == "fleet"
    with pytest.raises(ValueError, match="backend"):
        TD.DiSketchSystem({0: 4096}, "cs", rho_target=1.0, log2_te=LOG2_TE,
                          backend="pallas")
    for kw in ({"device": "cuda"}, {"device": "cpu"},
               {"fleet_kwargs": {"layout": "dense"}}):
        with pytest.raises(ValueError, match="host numpy"):
            TD.DiSketchSystem({0: 4096}, "cs", rho_target=1.0,
                              log2_te=LOG2_TE, backend="loop", **kw)
