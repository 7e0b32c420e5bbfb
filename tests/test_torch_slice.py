"""The fleet window path of the port end to end on the CPU, against the JAX
package's plain paths.

``DiSketchSystem(backend="fleet", device="cpu")`` replays a small Fat-Tree
workload with ``Replayer.run(system, window=4)``.  The reference is built
here from the loop backend's arithmetic under the window contract:
``repro.core.fragment.process_epoch`` per switch and epoch with ``ns``
frozen per window, then ``equalize.peb_epoch`` and ``next_n``.  Counters
must be bit-identical, the ``ns`` trajectory equal, PEBs within 1e-6
relative (f32 counters, float64 sums), and ``query_flows(merge=
"fragment")`` within 1e-6 relative of ``query_window(merge="fragment")``
on the reference records (the ``docs/kernels.md`` §4 contract).

The two query planes are also crossed over: the reference's jnp engine
answers from the port's window stack, and the port's engine from the
reference's counters (``FleetEpochRunner.from_window``).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import equalize as REQ
from repro.core import fleet as RF
from repro.core import query as RQ
from repro.core.disketch import SwitchStream as RStream
from repro.core.fragment import FragmentConfig as RCfg
from repro.core.fragment import process_epoch
from repro.net.simulator import Replayer as RReplayer
from repro.net.topology import FatTree as RFatTree
from repro.net.traffic import gen_workload as r_gen_workload
from repro.net.traffic import gini_memories as r_gini_memories
from repro_torch.core.disketch import DiSketchSystem
from repro_torch.core.fleet import FleetEpochRunner
from repro_torch.core.fragment import FragmentConfig as TCfg
from repro_torch.kernels.sketch_query import engine as TE
from repro_torch.net.simulator import Replayer
from repro_torch.net.topology import FatTree
from repro_torch.net.traffic import gen_workload, gini_memories

LOG2_TE = 12
N_EPOCHS = 8
WINDOW = 4
SRC = Path(__file__).resolve().parents[1] / "src"
WL_KW = dict(n_flows=3000, total_packets=40_000, n_epochs=N_EPOCHS,
             log2_te=LOG2_TE, burstiness=0.2, seed=1)


_REF_ENGINE = """
import sys, warnings
import numpy as np
# jax 0.9 deprecates the jax.experimental.shard_map import the engine
# makes; this interpreter only runs the engine, so the warning is moot.
warnings.filterwarnings("ignore", category=DeprecationWarning)
from repro.kernels.sketch_query.engine import fleet_window_query_device
for line in sys.stdin:
    src, dst = line.split()
    d = np.load(src)
    np.savez(dst, **{
        f"est{i}": fleet_window_query_device(
            d[f"stack{i}"], list(d[f"params{i}"]), d[f"keys{i}"],
            str(d["kind"]), frag_sel=d[f"sel{i}"])
        for i in range(int(d["n"]))})
    print("done", flush=True)
"""


@pytest.fixture(scope="module")
def reference_engine(tmp_path_factory):
    """Window estimates from the reference's jnp query engine, computed in
    one child interpreter for the whole module.  Importing the engine
    emits a jax DeprecationWarning, which this repo's warning filter makes
    an error, and jax caches the deprecated attribute once an import
    succeeds; the child keeps that out of the JAX package's own tests in
    this process.  The returned function takes ``(stack, params_by_epoch,
    keys, frag_sel)`` jobs and returns their estimates."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(SRC)] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)))
    tmp = tmp_path_factory.mktemp("ref_engine")

    def run(kind, jobs):
        arrays = {"kind": kind, "n": len(jobs)}
        for i, (stack, params, keys, sel) in enumerate(jobs):
            arrays.update({f"stack{i}": stack, f"params{i}": np.stack(params),
                           f"keys{i}": keys, f"sel{i}": sel})
        src, dst = tmp / f"{kind}-in.npz", tmp / f"{kind}-out.npz"
        np.savez(src, **arrays)
        child.stdin.write(f"{src} {dst}\n")
        child.stdin.flush()
        assert child.stdout.readline().strip() == "done", \
            "the reference engine's interpreter failed"
        with np.load(dst) as out:
            return [out[f"est{i}"] for i in range(len(jobs))]

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
    mems = r_gini_memories(topo.n_switches, 6 * 1024, 0.4,
                           np.random.RandomState(101))
    return topo, wl, RReplayer(wl, topo.n_switches), \
        {sw: int(m) for sw, m in enumerate(mems)}


def test_workload_generators_match_reference():
    """gen_workload, the ECMP paths and gini_memories give the reference's
    arrays from the same seeds."""
    kw = dict(WL_KW, burstiness=0.3, arrival="poisson")
    for args in (WL_KW, kw):
        want = r_gen_workload(RFatTree(4), **args)
        got = gen_workload(FatTree(4), **args)
        for f in ("keys", "sizes", "path_mat", "pkt_flow", "pkt_ts"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert got.paths == want.paths
    for gini in (0.0, 0.4, 0.7):
        np.testing.assert_array_equal(
            gini_memories(20, 128 * 1024, gini, np.random.RandomState(101)),
            r_gini_memories(20, 128 * 1024, gini, np.random.RandomState(101)))


def _reference_replay(rep, mems, kind, rho, **cfg_kw):
    """The loop backend's arithmetic under the window contract."""
    frags = {sw: RCfg(sw, kind, m, **cfg_kw) for sw, m in mems.items()}
    ns = {sw: 1 for sw in mems}
    records, pebs_log, n_log, ns_by_window = {}, [], [], []
    empty = RStream(np.zeros(0, np.uint32), np.zeros(0, np.int64),
                    np.zeros(0, np.int64))
    for e0 in range(0, N_EPOCHS, WINDOW):
        frozen = dict(ns)
        ns_by_window.append(frozen)
        window_pebs = []
        for e in range(e0, min(e0 + WINDOW, N_EPOCHS)):
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
                ns[sw] = REQ.next_n(ns[sw], peb, rho)
            pebs_log.append(pebs)
            n_log.append(dict(ns))
    return frags, records, pebs_log, n_log, ns_by_window


def _ref_query(records, keys, paths, kind, epochs):
    """query_window(merge="fragment") per path group, as the reference's
    query_flows groups them."""
    out = np.zeros(len(keys))
    groups = {}
    for i, p in enumerate(paths):
        groups.setdefault(tuple(p), []).append(i)
    for path, idxs in groups.items():
        idxs = np.asarray(idxs)
        recs = [[records[e][sw] for sw in path] for e in epochs]
        out[idxs] = RQ.query_window(
            recs, keys[idxs], kind,
            single_hop=np.full(len(idxs), len(path) == 1),
            level=0 if kind == "um" else None, merge="fragment")
    return out


SLICE_CASES = {
    "cs": ("cs", 2.0, {}),
    "cms": ("cms", 2.0, {}),
    "um4": ("um", 2.0, dict(n_levels=4)),
    "cs-mit": ("cs", 2.0, dict(mitigation=True)),
}


@pytest.mark.parametrize("name", sorted(SLICE_CASES))
def test_fleet_window_path_matches_reference(scenario, reference_engine,
                                              name):
    topo, wl, rep, mems = scenario
    kind, rho, cfg_kw = SLICE_CASES[name]
    frags, ref_recs, ref_pebs, ref_n_log, ns_by_window = _reference_replay(
        rep, mems, kind, rho, **cfg_kw)
    system = DiSketchSystem(mems, kind, rho_target=rho, log2_te=LOG2_TE,
                            backend="fleet", device="cpu", **cfg_kw)
    Replayer(gen_workload(FatTree(4), **WL_KW), topo.n_switches).run(
        system, window=WINDOW)
    fleet = system.fleet
    assert max(max(n.values()) for n in ref_n_log) > 1  # control moved
    assert system.n_log == ref_n_log

    # queries first, while every window is still resident
    epochs = list(range(N_EPOCHS))
    sel = (wl.path_len == 5) | (wl.path_len == 1)
    keys, paths = wl.keys[sel], [p for p, s in zip(wl.paths, sel) if s]
    assert fleet.has_device_window(epochs)
    got = system.query_flows(keys, paths, epochs, merge="fragment")
    want = _ref_query(ref_recs, keys, paths, kind, epochs)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert all(buf._host is None for buf, _ in fleet._window_bufs.values())
    path0 = paths[0]
    k0 = keys[[p == path0 for p in paths]]
    np.testing.assert_array_equal(
        fleet.point_query(3, k0, path=path0),
        fleet.window_query([3], k0, path=path0))

    # the reference's jnp engine on the port's stack, and the port's
    # engine on the reference's counters, for one path group per window
    path = paths[int(np.argmax([len(p) for p in paths]))]
    k = keys[[p == path for p in paths]]
    row_sel = fleet._row_sel(path, 0)
    L = fleet.n_levels
    jobs, port_est = [], []
    for w, e0 in enumerate(range(0, N_EPOCHS, WINDOW)):
        es = list(range(e0, e0 + WINDOW))
        buf = fleet._window_bufs[e0][0]
        params = [fleet._params_log[e] for e in es]
        for e, p in zip(es, params):
            np.testing.assert_array_equal(
                p, RF.build_params(frags, e, ns_by_window[w],
                                   fleet.frag_order))
        port_stack = buf.dense_host()
        jobs.append((port_stack, params, k, row_sel))
        port_est.append(TE.fleet_window_query_device(
            buf.device(), params, k, kind, frag_sel=row_sel))
        ref_stack = np.zeros(port_stack.shape, np.float32)
        for e in es:
            for i, sw in enumerate(fleet.frag_order):
                c = ref_recs[e][sw].counters
                c = c if kind == "um" else c[None]
                ref_stack[e - e0, i * L:(i + 1) * L, :c.shape[1],
                          :c.shape[2]] = c
        carried = FleetEpochRunner.from_window(
            {sw: TCfg(sw, kind, m, **cfg_kw) for sw, m in mems.items()},
            LOG2_TE, e0, ns_by_window[w], params, ref_stack, device="cpu")
        np.testing.assert_allclose(
            carried.window_query(es, k, path=path),
            RQ.query_window([[ref_recs[e][sw] for sw in path] for e in es],
                            k, kind, single_hop=np.full(len(k), False),
                            level=0 if kind == "um" else None,
                            merge="fragment"),
            rtol=1e-6, atol=1e-6)
        assert buf._host is None
    for got_w, want_w in zip(port_est,
                             reference_engine(kind, jobs)):
        np.testing.assert_allclose(got_w, want_w, rtol=1e-6, atol=1e-6)

    # PEBs, then the record plane (its one host copy per window)
    for e in epochs:
        for sw in mems:
            assert system.peb_log[e][sw] == pytest.approx(ref_pebs[e][sw],
                                                          rel=1e-6)
            np.testing.assert_array_equal(system.records[e][sw].counters,
                                          ref_recs[e][sw].counters)
    assert not fleet.has_device_window(epochs)
    # materialized windows answer through the numpy twin, same numbers
    np.testing.assert_allclose(
        system.query_flows(keys, paths, epochs, merge="fragment"), got,
        rtol=1e-6, atol=1e-6)


def test_unported_options_raise():
    """What the port does not have yet raises instead of running another
    path: device meshes, XOR parity groups and churn events."""
    mems = {0: 4096, 1: 8192}
    for backend in ("fleet", "loop"):
        with pytest.raises(NotImplementedError, match="mesh"):
            DiSketchSystem(mems, "cs", rho_target=1.0, log2_te=LOG2_TE,
                           backend=backend, mesh=object(), device="cpu")
    system = DiSketchSystem(mems, "cs", rho_target=1.0, log2_te=LOG2_TE,
                            device="cpu")
    empty = {}
    with pytest.raises(NotImplementedError, match="churn"):
        system.run_epoch(0, empty, events=[object()])
    with pytest.raises(NotImplementedError, match="churn"):
        system.run_window(0, [empty], events_by_epoch=[[object()]])
    frags = {0: TCfg(0, "cs", 4096)}
    for kw in (dict(mesh=object()), dict(parity_groups=[[0]])):
        with pytest.raises(NotImplementedError):
            FleetEpochRunner(frags, LOG2_TE, device="cpu", **kw)
    # nothing was dispatched by the refused calls
    assert system.records == {} and system.n_log == []
