"""The JAX reference's answers at chip_smoke.py's §6.1 setting: the values
the smoke pins (``RHO["um"]``, ``RMSE_PIN``, ``AGG_RMSE_PIN``,
``ENTROPY_PIN``), computed on the CPU by the reference's numpy paths (the
loop backend, ``process_epoch``, ``query_window``) and, for the window-8
entropy at k_heavy 1024, its jnp device G-sum.

    PYTHONPATH=src python scripts/reference_pins.py [SECTION ...]

SECTIONs: rho, aggregated, rmse_epoch, rmse_window, um_epoch, um_window
(default: all).  Prints one ``name value`` line per result, then one JSON
object.  All sections take a few minutes at this full-scale setting.
"""
import json
import sys

import numpy as np

from repro.core import equalize as REQ
from repro.core import query as RQ
from repro.core.disketch import (AggregatedSystem, DiscoSystem,
                                 DiSketchSystem, SwitchStream,
                                 _g_entropy, calibrate_rho_target)
from repro.core.fragment import FragmentConfig, process_epoch
from repro.core.hashing import level_of
from repro.core.sketches import true_entropy
from repro.net.simulator import Replayer, rmse
from repro.net.topology import FatTree, core_on_path
from repro.net.traffic import gen_workload, gini_memories

# chip_smoke.py's setting
N_FLOWS, N_PACKETS, N_EPOCHS, LOG2_TE, SEED = 200_000, 2_000_000, 32, 16, 1
BASE_MEM, GINI, WINDOW = 128 * 1024, 0.4, 8
RHO = {"cs": 15.67, "cms": 1.0, "um": 63.31}
N_LEVELS, LEVEL_SEED, ENTROPY_EPOCHS = 16, 7777, 8
SECTIONS = ("rho", "aggregated", "rmse_epoch", "rmse_window", "um_epoch",
            "um_window")

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
    print(json.dumps(out))


if __name__ == "__main__":
    chosen = sys.argv[1:] or SECTIONS
    unknown = set(chosen) - set(SECTIONS)
    if unknown:
        raise SystemExit(f"unknown sections {sorted(unknown)}; "
                         f"choose from {SECTIONS}")
    main(chosen)
