"""The UnivMon all-levels query plane of the port on the CPU, against the
JAX package.

* ``um_window_query_device`` (the batched gather/merge over every
  (epoch, fragment, level) row) against the reference's jnp engine, run in
  a child interpreter as ``tests/test_torch_slice.py`` runs it, on a
  window stack built from the reference's loop records: <= 1e-6 relative.
* ``um_gsum_device`` (the top-down G-sum in torch ops) against the
  reference's ``um_gsum_combine`` where ``k_heavy`` does not bind
  (<= 1e-5 relative, f32 against float64), and against the reference's
  device G-sum on exact ties at the ``k_heavy`` cutoff (the stable sort
  must pick the keys ``lax.top_k`` picks).
* ``DiSketchSystem.query_entropy`` with both merges against the reference
  on the same trace: 1e-9 relative on the numpy record plane, 1e-5 on the
  device plane.
* The ``examples/network_monitoring.py`` pipeline at a small size.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import equalize as REQ
from repro.core import fleet as RF
from repro.core import query as RQ
from repro.core.disketch import DiSketchSystem as RDiSketch
from repro.core.disketch import SwitchStream as RStream
from repro.core.disketch import calibrate_rho_target as r_calibrate
from repro.core.fragment import FragmentConfig as RCfg
from repro.core.fragment import process_epoch
from repro.core.sketches import true_entropy as r_true_entropy
from repro.net.simulator import Replayer as RReplayer
from repro.net.topology import FatTree as RFatTree
from repro.net.traffic import gen_workload as r_gen_workload
from repro.net.traffic import gini_memories as r_gini_memories
from repro_torch import obs
from repro_torch.core import fleet as fleet_module
from repro_torch.core import query as Q
from repro_torch.core.disketch import (DiSketchSystem, _g_entropy,
                                       calibrate_rho_target)
from repro_torch.core.hashing import level_of
from repro_torch.core.sketches import true_entropy
from repro_torch.kernels.sketch_query import (um_gsum_device,
                                              um_window_query_device)
from repro_torch.net.simulator import FailureSchedule, Replayer, rmse
from repro_torch.net.topology import FatTree
from repro_torch.net.traffic import (cov_list, gen_workload, gini_memories,
                                     linear_path_workload)
from torch_threads import one_thread  # noqa: F401

LOG2_TE = 12
N_EPOCHS = 4
WINDOW = 2
RHO = 2.0
SRC = Path(__file__).resolve().parents[1] / "src"
WL_KW = dict(n_flows=2000, total_packets=30_000, n_epochs=N_EPOCHS,
             log2_te=LOG2_TE, burstiness=0.2, seed=3)


def _entropy_np(x):
    return x * np.log2(np.maximum(x, 1.0))


_REF_ENGINE = """
import sys, warnings
import numpy as np
# jax 0.9 deprecates the jax.experimental.shard_map import the engine
# makes; this interpreter only runs the engine, so the warning is moot.
warnings.filterwarnings("ignore", category=DeprecationWarning)
import jax.numpy as jnp
from repro.kernels.sketch_query.engine import (um_gsum_device,
                                               um_window_query_device)


def g_entropy(x):
    return x * jnp.log2(jnp.maximum(x, 1.0))


def g_identity(x):
    return x


G = {"entropy": g_entropy, "identity": g_identity}
for line in sys.stdin:
    op, src, dst = line.split()
    d = np.load(src)
    if op == "um":
        out = {"est": um_window_query_device(
            d["stack"], list(d["params"]), d["keys"], int(d["n_levels"]),
            frag_sel=d["sel"])}
    else:
        out = {"y": np.float64(um_gsum_device(
            d["ests"], d["lvl"], G[str(d["g"])], k_heavy=int(d["k_heavy"])))}
    np.savez(dst, **out)
    print("done", flush=True)
"""


@pytest.fixture(scope="module")
def reference_engine(tmp_path_factory):
    """The reference's ``um_window_query_device`` (op ``"um"``) and
    ``um_gsum_device`` (op ``"gsum"``) in one child interpreter for the
    module: importing the engine in this process would trip a jax
    DeprecationWarning that jax then caches (see test_torch_slice.py)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(SRC)] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)))
    tmp = tmp_path_factory.mktemp("ref_um_engine")
    calls = [0]

    def run(op, **arrays):
        calls[0] += 1
        src, dst = tmp / f"in{calls[0]}.npz", tmp / f"out{calls[0]}.npz"
        np.savez(src, **arrays)
        child.stdin.write(f"{op} {src} {dst}\n")
        child.stdin.flush()
        assert child.stdout.readline().strip() == "done", \
            "the reference engine's interpreter failed"
        with np.load(dst) as out:
            return {k: out[k] for k in out.files}

    with subprocess.Popen([sys.executable, "-c", _REF_ENGINE], env=env,
                          stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                          text=True) as child:
        yield run
        child.stdin.close()
        assert child.wait(timeout=60) == 0


@pytest.fixture(scope="module")
def scenario():
    topo = RFatTree(4)
    wl = r_gen_workload(topo, **WL_KW)
    mems = r_gini_memories(topo.n_switches, 24 * 1024, 0.4,
                           np.random.RandomState(101))
    return topo, wl, RReplayer(wl, topo.n_switches), \
        {sw: int(m) for sw, m in enumerate(mems)}


def _port_replay(mems, n_levels, window=1, **fleet_kw):
    system = DiSketchSystem(mems, "um", rho_target=RHO, log2_te=LOG2_TE,
                            n_levels=n_levels, device="cpu",
                            fleet_kwargs=fleet_kw or None)
    Replayer(gen_workload(FatTree(4), **WL_KW), 20).run(system,
                                                         window=window)
    return system


def _record_plane(system):
    """A view of ``system`` whose queries take the record plane: the same
    records, no fleet to answer on the device."""
    view = DiSketchSystem.__new__(DiSketchSystem)
    view.__dict__.update(system.__dict__, fleet=None)
    return view


def _reference_window_replay(rep, mems, n_levels):
    """The reference's loop arithmetic under the window contract (``ns``
    frozen for each window, Eq. 6 replayed at its end), as the fleet window
    path runs it: ``(fragments, records, ns of each window)``."""
    frags = {sw: RCfg(sw, "um", m, n_levels=n_levels)
             for sw, m in mems.items()}
    ns = {sw: 1 for sw in mems}
    records, ns_by_window = {}, []
    empty = RStream(np.zeros(0, np.uint32), np.zeros(0, np.int64),
                    np.zeros(0, np.int64))
    for e0 in range(0, N_EPOCHS, WINDOW):
        frozen = dict(ns)
        ns_by_window.append(frozen)
        window_pebs = []
        for e in range(e0, e0 + WINDOW):
            records[e], pebs = {}, {}
            for sw, cfg in frags.items():
                st = rep.epoch_stream(e).get(sw, empty)
                rec = process_epoch(cfg, e, frozen[sw], st.keys, st.values,
                                    st.ts, e << LOG2_TE, LOG2_TE,
                                    single_hop=st.single_hop)
                records[e][sw] = rec
                pebs[sw] = REQ.peb_epoch(rec)
            window_pebs.append(pebs)
        for pebs in window_pebs:
            for sw, peb in pebs.items():
                ns[sw] = REQ.next_n(ns[sw], peb, RHO)
    return frags, records, ns_by_window


def _by_path(keys, paths):
    groups = {}
    for i, p in enumerate(paths):
        groups.setdefault(tuple(p), []).append(i)
    return {p: np.asarray(i) for p, i in groups.items()}


@pytest.mark.parametrize("n_levels", [4, 8])
def test_um_window_query_device_matches_reference_engine(
        scenario, reference_engine, n_levels):
    """The port's all-levels window query, on the port's own resident row
    groups and on a dense stack of the reference's loop records, against
    the reference's jnp engine on that stack, for every window and a
    5-hop, a 3-hop and a 1-hop path group."""
    topo, wl, rep, mems = scenario
    frags, recs, ns_by_window = _reference_window_replay(rep, mems, n_levels)
    system = _port_replay(mems, n_levels, window=WINDOW)
    fleet = system.fleet
    order = fleet.frag_order
    assert max(max(ns.values()) for ns in ns_by_window) > 1
    groups = _by_path(wl.keys, wl.paths)
    chosen = [next(p for p in groups if len(p) == h) for h in (5, 3, 1)]
    for w, e0 in enumerate(range(0, N_EPOCHS, WINDOW)):
        es = list(range(e0, e0 + WINDOW))
        params = [RF.build_params(frags, e, ns_by_window[w], order)
                  for e in es]
        for e, p in zip(es, params):
            np.testing.assert_array_equal(fleet._params_log[e], p)
        n_max = max(ns_by_window[w].values())
        w_max = max(cfg.width for cfg in frags.values())
        stack = np.zeros((WINDOW, len(order) * n_levels, n_max, w_max),
                         np.float32)
        for e in es:
            for i, sw in enumerate(order):
                c = recs[e][sw].counters
                stack[e - e0, i * n_levels:(i + 1) * n_levels,
                      :c.shape[1], :c.shape[2]] = c
        buf = fleet._window_bufs[e0][0]
        for path in chosen:
            keys = wl.keys[groups[path]]
            sel = np.array([sw in path for sw in order])
            want = reference_engine(
                "um", stack=stack, params=np.stack(params), keys=keys,
                n_levels=n_levels, sel=sel)["est"]
            assert want.shape == (n_levels, len(keys))
            on_ref = um_window_query_device(torch.from_numpy(stack), params,
                                            keys, n_levels, frag_sel=sel)
            on_port = um_window_query_device(buf.device(), params, keys,
                                             n_levels, frag_sel=sel)
            np.testing.assert_allclose(on_ref, want, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(on_port, want, rtol=1e-6, atol=1e-6)
            # per-epoch (E, F) liveness masks give the same answer
            np.testing.assert_allclose(
                um_window_query_device(buf.device(), params, keys, n_levels,
                                       frag_sel=np.tile(sel, (WINDOW, 1))),
                on_port, rtol=1e-12)
        assert buf._host is None


def test_um_window_query_device_refusals():
    """An all-masked epoch, a row count that is not whole fragments and a
    mask of the wrong shape raise instead of answering."""
    params = np.zeros((4, 8), np.int32)
    params[:, 3], params[:, 4] = 16, 1
    stack = torch.zeros((1, 4, 1, 16))
    keys = np.arange(5, dtype=np.uint32)
    with pytest.raises(ValueError, match="no on-path fragment"):
        um_window_query_device(stack, [params], keys, 2,
                               frag_sel=np.zeros(2, bool))
    with pytest.raises(ValueError, match="whole fragments"):
        um_window_query_device(stack, [params], keys, 3)
    with pytest.raises(ValueError, match="frag_sel"):
        um_window_query_device(stack, [params], keys, 2,
                               frag_sel=np.ones(3, bool))
    assert um_window_query_device(stack, [params], keys[:0], 2).shape == \
        (2, 0)


def _gsum_case(seed, n_levels=6, n_keys=200):
    rng = np.random.RandomState(seed)
    lvl = rng.randint(0, n_levels, n_keys)
    ests = np.zeros((n_levels, n_keys))
    for l in range(n_levels):
        m = lvl >= l
        ests[l, m] = rng.randint(1, 5000, int(m.sum()))
    return ests, lvl


@pytest.mark.parametrize("seed", [11, 12])
def test_um_gsum_device_matches_host_combine(seed):
    """The torch G-sum == the reference's float64 numpy combine where
    ``k_heavy >= K``, so no tie can pick other keys (mirror of
    tests/test_univmon_fleet.py's case, seed 11, and one more)."""
    ests, lvl = _gsum_case(seed)
    got = um_gsum_device(ests, lvl, lambda x: x * torch.log2(
        torch.clamp_min(x, 1.0)), k_heavy=1024, device="cpu")
    want = RQ.um_gsum_combine(ests, lvl, _entropy_np, k_heavy=1024)
    assert got == pytest.approx(want, rel=1e-5)
    assert Q.um_gsum_combine(ests, lvl, _entropy_np, k_heavy=1024) == want


def _tie_case():
    """Estimates with exact ties straddling the ``k_heavy`` cutoff at every
    level, the tied keys split between ``in_next`` 0 and 1, so a selection
    that breaks ties otherwise than by the lower index changes the sum."""
    rng = np.random.RandomState(5)
    n_levels, n_keys = 4, 96
    lvl = rng.randint(0, n_levels, n_keys)
    ests = np.zeros((n_levels, n_keys))
    for l in range(n_levels):
        m = np.flatnonzero(lvl >= l)
        ests[l, m] = rng.choice([7.0, 7.0, 7.0, 40.0, 300.0], len(m))
    return ests, lvl


def _gsum_lower_index_first(ests, lvl, g, k_heavy, lower_first=True):
    """The G-sum with top-k ties broken by the lower (or the higher) key
    index, in float64."""
    y = 0.0
    for l in range(ests.shape[0] - 1, -1, -1):
        idx = np.flatnonzero(lvl >= l)
        est = np.maximum(ests[l, idx], 1.0)
        pos = np.arange(len(idx)) if lower_first else -np.arange(len(idx))
        order = np.lexsort((pos, -est))[:k_heavy]
        gv = g(est[order])
        in_next = (lvl[idx][order] >= l + 1).astype(np.float64)
        y = float(gv.sum()) if l == ests.shape[0] - 1 else \
            2.0 * y + float(((1.0 - 2.0 * in_next) * gv).sum())
    return y


def test_um_gsum_device_breaks_ties_as_the_reference(reference_engine):
    """On exact ties at the ``k_heavy`` cutoff the torch G-sum picks the
    keys the reference's ``lax.top_k`` picks (the lower index first).  With
    ``g(x) = x`` every sum is an integer, exact in f32, so the two must be
    equal; the entropy ``g`` agrees to f32 rounding."""
    ests, lvl = _tie_case()
    k_heavy = 10
    lower = _gsum_lower_index_first(ests, lvl, lambda x: x, k_heavy)
    higher = _gsum_lower_index_first(ests, lvl, lambda x: x, k_heavy,
                                     lower_first=False)
    assert lower != higher          # the case tells the two orders apart
    got = um_gsum_device(ests, lvl, lambda x: x, k_heavy=k_heavy,
                         device="cpu")
    want = float(reference_engine("gsum", ests=ests, lvl=lvl, g="identity",
                                  k_heavy=k_heavy)["y"])
    assert got == want == lower
    got = um_gsum_device(ests, lvl, lambda x: x * torch.log2(
        torch.clamp_min(x, 1.0)), k_heavy=k_heavy, device="cpu")
    want = float(reference_engine("gsum", ests=ests, lvl=lvl, g="entropy",
                                  k_heavy=k_heavy)["y"])
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("n_levels", [4, 8])
def test_query_entropy_per_epoch_matches_reference_loop(scenario, n_levels):
    """Per-epoch control: the port's fleet replay (its groups kept on the
    CPU device) against the reference's loop backend on the same trace.
    The subepoch merge runs on the records, bit-identical to the
    reference's, so the entropy agrees to 1e-9; the fragment merge runs on
    the device plane (f32 merge and G-sum), 1e-5."""
    topo, wl, rep, mems = scenario
    ref = RDiSketch(mems, "um", rho_target=RHO, log2_te=LOG2_TE,
                    n_levels=n_levels)
    rep.run(ref)
    system = _port_replay(mems, n_levels, keep_stacked=True)
    assert system.n_log == ref.n_log
    epochs = list(range(N_EPOCHS))
    total = float(wl.sizes.sum())
    # The device G-sum selects a level's k_heavy largest estimates as the
    # reference's device plane does (ties: lower index first, held by
    # test_um_gsum_device_breaks_ties_as_the_reference); the host combine
    # takes numpy's unstable argsort, so where k_heavy binds the two may
    # keep other keys among exact ties.  The planes are compared where it
    # does not bind; the record plane at the default k_heavy too.
    for merge, rel, k_heavy in (("subepoch", 1e-9, 1024),
                                ("fragment", 1e-9, 1024),
                                ("fragment", 1e-5, len(wl.keys))):
        want = ref.query_entropy(wl.keys, wl.paths, epochs, total,
                                 n_levels=n_levels, merge=merge,
                                 k_heavy=k_heavy)
        got = (system.query_entropy if (merge, k_heavy) != (
            "fragment", 1024) else _record_plane(system).query_entropy)(
            wl.keys, wl.paths, epochs, total, n_levels=n_levels,
            merge=merge, k_heavy=k_heavy)
        assert got == pytest.approx(want, rel=rel), (merge, k_heavy)
    assert system.fleet.has_device_window(epochs)
    assert all(b._host is None for b, _ in system.fleet._window_bufs.values())
    # a level count other than the fleet's goes to the record plane
    got = system.query_entropy(wl.keys, wl.paths, epochs[:2], total,
                               n_levels=n_levels // 2, merge="fragment")
    want = ref.query_entropy(wl.keys, wl.paths, epochs[:2], total,
                             n_levels=n_levels // 2, merge="fragment")
    assert got == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("n_levels", [4, 8])
def test_query_entropy_window_matches_reference(scenario, n_levels):
    """The window path: the device plane's fragment-merge entropy against
    the reference's ``um_entropy_window`` on its loop records under the
    window contract (1e-5); then, after the record plane copies the
    windows to the host (as row groups), both merges on the records
    (1e-9), and the host per-level query against the device one."""
    topo, wl, rep, mems = scenario
    frags, recs, _ = _reference_window_replay(rep, mems, n_levels)
    system = _port_replay(mems, n_levels, window=WINDOW)
    fleet = system.fleet
    epochs = list(range(N_EPOCHS))
    total = float(wl.sizes.sum())
    groups = _by_path(wl.keys, wl.paths)
    ref_recs = [[[recs[e][sw] for sw in path] for e in epochs]
                for path in groups]
    keysets = [wl.keys[i] for i in groups.values()]

    def want(merge, k_heavy=1024):
        return RQ.um_entropy_window(ref_recs, keysets, n_levels, 7777,
                                    total, k_heavy=k_heavy, merge=merge)

    # k_heavy does not bind on the device plane (see the per-epoch test)
    k_all = len(wl.keys)
    got = system.query_entropy(wl.keys, wl.paths, epochs, total,
                               n_levels=n_levels, merge="fragment",
                               k_heavy=k_all)
    assert got == pytest.approx(want("fragment", k_all), rel=1e-5)
    path = next(p for p in groups if len(p) == 5)
    keys = wl.keys[groups[path]]
    dev_levels = fleet.um_level_window_query(epochs, keys, path=path)
    assert all(b._host is None for b, _ in fleet._window_bufs.values())

    for e in epochs:
        for sw in mems:
            np.testing.assert_array_equal(system.records[e][sw].counters,
                                          recs[e][sw].counters)
    assert not fleet.has_device_window(epochs)
    np.testing.assert_allclose(
        fleet.um_level_window_query(epochs, keys, path=path), dev_levels,
        rtol=1e-6, atol=1e-6)
    for merge in ("fragment", "subepoch"):
        got = system.query_entropy(wl.keys, wl.paths, epochs, total,
                                   n_levels=n_levels, merge=merge)
        assert got == pytest.approx(want(merge), rel=1e-9), merge


def test_um_level_window_query_refusals(scenario):
    """A cs fleet has no level stack, an unknown failure policy is
    refused, as on the frequency path, and so is a grouped query with a
    key in no path group."""
    topo, wl, rep, mems = scenario
    cs = DiSketchSystem(mems, "cs", rho_target=RHO, log2_te=LOG2_TE,
                        device="cpu")
    with pytest.raises(ValueError, match="UnivMon"):
        cs.fleet.um_level_window_query([0], wl.keys[:4])
    with pytest.raises(ValueError, match="UnivMon"):
        cs.query_entropy(wl.keys[:4], wl.paths[:4], [0], 4.0)
    um = DiSketchSystem(mems, "um", rho_target=RHO, log2_te=LOG2_TE,
                        n_levels=4, device="cpu")
    with pytest.raises(ValueError, match="failure"):
        um.query_entropy(wl.keys[:4], wl.paths[:4], [0], 4.0,
                         failures="sometimes")
    with pytest.raises(ValueError, match="1 keys are in no path group"):
        um.fleet.um_level_window_query_groups([0], wl.keys[:4],
                                              [(None, np.arange(3))])


# --- mirrors of tests/test_univmon_fleet.py --------------------------------

N_LEVELS = 4


def _small_workload(n_hops=5, seed=1, n_epochs=4, mem_scale=8):
    rng = np.random.RandomState(seed)
    widths = np.maximum(cov_list(n_hops, 1280 * mem_scale, 1.2,
                                 rng).astype(int), 4)
    mems = {h: int(w) * 4 for h, w in enumerate(widths)}
    loads = np.maximum(cov_list(n_hops, 30_000, 0.9, rng).astype(int), 16)
    wl = linear_path_workload(n_hops, eval_flows=100, eval_packets=800,
                              bg_packets_per_hop=loads, n_epochs=n_epochs,
                              seed=seed)
    return wl, Replayer(wl, n_hops), mems


def _windowed_um(wl, rep, mems, window=4):
    sysw = DiSketchSystem(mems, "um", rho_target=4.0, log2_te=wl.log2_te,
                          n_levels=N_LEVELS, device="cpu")
    rep.run(sysw, window=window)
    return sysw


def test_um_entropy_device_matches_host_fragment_merge():
    """query_entropy(merge='fragment'): the device path (batched
    all-levels query + top-down G-sum) matches the per-record host
    estimator, and never copies the window to the host."""
    wl, rep, mems = _small_workload()
    a = _windowed_um(wl, rep, mems)
    b = _windowed_um(wl, rep, mems)
    epochs = list(range(wl.n_epochs))
    total = float(wl.sizes.sum())
    ent_dev = a.query_entropy(wl.keys, wl.paths, epochs, total,
                              n_levels=N_LEVELS, merge="fragment")
    assert a.fleet._window_bufs[0][0]._host is None
    for e in epochs:
        b.records[e][0]                     # force the host/record path
    assert not b.fleet.has_device_window(epochs)
    ent_host = b.query_entropy(wl.keys, wl.paths, epochs, total,
                               n_levels=N_LEVELS, merge="fragment")
    assert ent_dev == pytest.approx(ent_host, rel=1e-4)


@pytest.mark.parametrize("path", [None, (2,), (1, 3)])
def test_um_device_level_query_matches_host_oracle(path):
    """Device all-levels gather/merge == the per-level numpy oracle on the
    host groups of the same window, path restriction on and off, and the
    window stays on the device until the oracle asks for it."""
    wl, rep, mems = _small_workload()
    sysw = _windowed_um(wl, rep, mems)
    keys = wl.keys[:65]
    epochs = list(range(wl.n_epochs))
    got = sysw.fleet.um_level_window_query(epochs, keys, path=path)
    assert got.shape == (N_LEVELS, len(keys))
    buf = sysw.fleet._window_bufs[0][0]
    assert buf._host is None and buf.resident
    ref = np.zeros_like(got)
    for level in range(N_LEVELS):
        ref[level] = Q.fleet_query_window(
            [buf.host_epoch(e) for e in epochs],
            [sysw.fleet._params_log[e] for e in epochs],
            None, keys, "um", frag_sel=sysw.fleet._row_sel(path, level))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


# --- the grouped on-path gather ---------------------------------------------

#: the grouped-gather cases: no churn, then each policy on a fleet where
#: switch 3 (on the 5-hop path and its own single hop) dies at epoch 3,
#: inside the window 2-3, so its epoch-2 cell is lost (parity rebuilds it
#: under "recover") and the group (3,) is blind in epochs 2 and 3 ("mask")
UM_CHURN = [None, "mask", "recover", "oblivious"]


def _grouped_um(failures):
    """A windowed (windows of 2) UnivMon fleet of the 5-hop workload, with
    switch 3 down from epoch 3 unless ``failures`` is None; parity groups
    {0, 1, 2} and {3, 4}.  Returns the workload, the system, the churn
    policy to query with, and every key in ``path_groups`` order as one
    batch with its ``(path, idxs)`` groups."""
    wl, rep, mems = _small_workload()
    s = DiSketchSystem(mems, "um", rho_target=4.0, log2_te=wl.log2_te,
                       n_levels=N_LEVELS, device="cpu",
                       fleet_kwargs={"parity_groups": [[0, 1, 2], [3, 4]]})
    rep.run(s, window=2, failures=None if failures is None else
            FailureSchedule(5, downs={3: (3, None)}))
    by_path = Q.path_groups(wl.paths)
    ks = np.concatenate([wl.keys[i] for i in by_path.values()])
    ends = np.cumsum([len(i) for i in by_path.values()])
    groups = [(p, np.arange(b - len(i), b))
              for (p, i), b in zip(by_path.items(), ends)]
    return wl, s, failures or "mask", ks, groups


@pytest.mark.parametrize("failures", UM_CHURN)
def test_um_grouped_gather_equals_one_group_calls(monkeypatch, failures):
    """The grouped on-path gather's (L, K) estimates equal, bit for bit,
    the one-group calls over the same path groups, concatenated: with and
    without churn, under each policy, with a group blind in two epochs
    and key chunks of 7 that cut through the groups; and in any order of
    the batch."""
    monkeypatch.setattr(fleet_module, "QUERY_CHUNK", 7)
    wl, s, policy, ks, groups = _grouped_um(failures)
    epochs = list(range(wl.n_epochs))
    got = s.fleet.um_level_window_query_groups(epochs, ks, groups,
                                               failures=policy)
    assert got.dtype == torch.float64 and got.shape == (N_LEVELS, len(ks))
    want = np.concatenate([s.fleet.um_level_window_query(
        epochs, ks[i], path=p, failures=policy) for p, i in groups], axis=1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()
    # the batch's order is the caller's: shuffled keys, shuffled estimates
    perm = np.random.RandomState(0).permutation(len(ks))
    at = np.argsort(perm)
    shuffled = s.fleet.um_level_window_query_groups(
        epochs, ks[perm], [(p, at[i]) for p, i in groups], failures=policy)
    np.testing.assert_array_equal(shuffled.numpy(), want[:, perm])
    blind = s.fleet.um_level_window_query(epochs, ks[:3], path=(3,),
                                          failures=policy)
    seen = s.fleet.last_observability["observable_epochs"]
    assert seen == {None: 4, "mask": 2, "recover": 3, "oblivious": 4}[
        failures]
    assert np.isfinite(blind).all()


@pytest.mark.parametrize("failures", UM_CHURN)
def test_um_entropy_is_the_gsum_of_the_grouped_estimates(failures):
    """``query_entropy(merge="fragment")`` is exactly the device G-sum of
    the one-group estimates concatenated in ``path_groups`` order."""
    wl, s, policy, ks, groups = _grouped_um(failures)
    epochs = list(range(wl.n_epochs))
    total = float(wl.sizes.sum())
    got = s.query_entropy(wl.keys, wl.paths, epochs, total,
                          n_levels=N_LEVELS, merge="fragment",
                          failures=policy)
    ests = np.concatenate([s.fleet.um_level_window_query(
        epochs, ks[i], path=p, failures=policy) for p, i in groups], axis=1)
    g = um_gsum_device(ests, level_of(ks, 7777, N_LEVELS), _g_entropy,
                       device="cpu")
    assert got == float(np.log2(total) - g / total)


def test_um_grouped_gather_counts_on_path_slots():
    """The ``query.gather`` span of each window counts the (epoch,
    fragment, level, key) slots of each key's own path, Sum_g E L |path_g|
    K_g, far below the E R K of a gather of every row, and the path
    groups it served."""
    wl, s, policy, ks, groups = _grouped_um(None)
    epochs = list(range(wl.n_epochs))
    obs.clear()
    s.fleet.um_level_window_query_groups(epochs, ks, groups)
    spans = [x for x in obs.spans() if x.name == "query.gather"]
    assert len(spans) == 2                               # windows of 2
    assert all(x.counts["groups"] == len(groups) for x in spans)
    slots = sum(x.counts["slots"] for x in spans)
    want = sum(len(epochs) * N_LEVELS * len(p) * len(i) for p, i in groups)
    assert slots == want
    assert slots < len(epochs) * 5 * N_LEVELS * len(ks) / 2


def test_um_entropy_keeps_estimates_on_the_device(monkeypatch):
    """The entropy's (L, K) estimates never reach the host: the windows
    stay resident, no ``query.estimates.wait`` span opens, and the only
    device tensor that goes to the host is the G-sum's scalar (under the
    armed guard, which would raise on any other read)."""
    from repro_torch import sanitize

    wl, s, policy, ks, groups = _grouped_um("mask")
    epochs = list(range(wl.n_epochs))
    monkeypatch.setenv(sanitize._ENV, "1")
    obs.clear()
    s.query_entropy(wl.keys, wl.paths, epochs, float(wl.sizes.sum()),
                    n_levels=N_LEVELS, merge="fragment")
    names = [x.name for x in obs.spans()]
    assert "query.estimates.wait" not in names
    assert names.count("query.gsum.wait") == 1
    assert names.count("fleet.liveness") == names.count("hash.level_of") \
        == 1
    assert all(b.resident and b._host is None
               for b, _ in s.fleet._window_bufs.values())


def test_network_monitoring_pipeline_matches_reference():
    """``examples/network_monitoring.py`` at a small size on the port
    (device="cpu"), against the same steps on the reference's loop
    backend: calibration, the per-epoch UnivMon replay (fleet == the
    port's loop, bit for bit), Q1 frequencies of the 5-hop flows, Q2 top-20
    heavy hitters, Q3 entropy, Q4 subepoch counts; then the example's
    window mode, whose device query equals the record plane."""
    topo = FatTree(4)
    rng = np.random.RandomState(42)
    mem = gini_memories(topo.n_switches, 64 * 1024, 0.4, rng)
    memories = {sw: int(m) for sw, m in enumerate(mem)}
    kw = dict(n_flows=3000, total_packets=30_000, n_epochs=4, seed=7)
    wl = gen_workload(topo, **kw)
    rwl = r_gen_workload(RFatTree(4), **kw)
    rep, rrep = Replayer(wl, topo.n_switches), RReplayer(rwl, 20)
    rho = calibrate_rho_target(memories, "um",
                               rep.epoch_stream(wl.n_epochs // 2),
                               wl.log2_te, n_levels=8, device="cpu")
    assert rho == r_calibrate(memories, "um",
                              rrep.epoch_stream(wl.n_epochs // 2),
                              wl.log2_te, n_levels=8)
    sysd = DiSketchSystem(memories, "um", rho_target=rho,
                          log2_te=wl.log2_te, n_levels=8, device="cpu")
    rep.run(sysd)
    sysl = DiSketchSystem(memories, "um", rho_target=rho,
                          log2_te=wl.log2_te, n_levels=8, backend="loop")
    rep.run(sysl)
    ref = RDiSketch(memories, "um", rho_target=rho, log2_te=wl.log2_te,
                    n_levels=8)
    rrep.run(ref)
    assert sysl.ns == sysd.ns == ref.ns
    for sw in memories:
        np.testing.assert_array_equal(sysl.records[3][sw].counters,
                                      sysd.records[3][sw].counters)
        np.testing.assert_array_equal(ref.records[3][sw].counters,
                                      sysd.records[3][sw].counters)
    epochs = list(range(wl.n_epochs))
    sel = wl.path_len == 5
    keys, truth = wl.keys[sel], wl.sizes[sel]
    paths = [p for p, s in zip(wl.paths, sel) if s]
    est = sysd.query_flows(keys, paths, epochs)                 # Q1
    np.testing.assert_allclose(est, ref.query_flows(keys, paths, epochs),
                               rtol=1e-12)
    assert np.isfinite(rmse(est, truth))
    top = np.argsort(-est)[:20]                                  # Q2
    true_top = set(np.argsort(-truth)[:20])
    assert sum(1 for i in top if i in true_top) > 0
    total = float(wl.sizes.sum())
    ent = sysd.query_entropy(wl.keys, wl.paths, epochs, total,  # Q3
                             n_levels=8)
    assert ent == pytest.approx(ref.query_entropy(
        wl.keys, wl.paths, epochs, total, n_levels=8), rel=1e-9)
    assert true_entropy(wl.sizes) == r_true_entropy(rwl.sizes)
    assert abs(ent - true_entropy(wl.sizes)) < 1.0
    ns = np.array(list(sysd.ns.values()))                       # Q4
    assert ((ns >= 1) & (ns & (ns - 1) == 0)).all()

    sysw = DiSketchSystem(memories, "um", rho_target=rho,
                          log2_te=wl.log2_te, n_levels=8, device="cpu")
    rep.run(sysw, window=4)
    est_dev = sysw.query_flows(keys[:256], paths[:256], epochs,
                               merge="fragment")
    assert sysw.fleet._window_bufs[0][0].resident
    for e in epochs:
        sysw.records[e][0]                     # materialize window records
    est_rec = sysw.query_flows(keys[:256], paths[:256], epochs,
                               merge="fragment")
    np.testing.assert_allclose(est_dev, est_rec, rtol=1e-6)


def test_level_of_matches_reference():
    """The level membership the G-sum masks with is the reference's."""
    from repro.core.hashing import level_of as r_level_of

    keys = np.random.RandomState(0).randint(0, 2 ** 32, 4096,
                                            dtype=np.int64).astype(np.uint32)
    for n_levels in (4, 8, 16):
        np.testing.assert_array_equal(level_of(keys, 7777, n_levels),
                                      r_level_of(keys, 7777, n_levels))
