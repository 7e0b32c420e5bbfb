"""The benchmark's copy of the trace generator against the program's."""
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench.gen.trace import gini_memories, make_trace

from .sizes import SMALL

ROOT = Path(__file__).resolve().parents[2]
SPEC = dict(json.loads((ROOT / "perfbench/configs/disketch-cs-s61.json")
                       .read_text())["trace"], **SMALL["trace"])


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_streams_match_the_port_replayer(seed):
    from repro_torch.net.simulator import Replayer
    from repro_torch.net.topology import FatTree
    from repro_torch.net.traffic import gen_workload

    ours = make_trace(SPEC, seed)
    wl = gen_workload(FatTree(4), n_flows=SPEC["n_flows"],
                      total_packets=SPEC["total_packets"],
                      alpha=SPEC["alpha"], n_epochs=SPEC["n_epochs"],
                      log2_te=SPEC["log2_te"],
                      burstiness=SPEC["burstiness"], seed=seed,
                      arrival=SPEC["arrival"],
                      max_flow_frac=SPEC["max_flow_frac"])
    np.testing.assert_array_equal(ours.keys, wl.keys)
    np.testing.assert_array_equal(ours.sizes, wl.sizes)
    np.testing.assert_array_equal(ours.path_mat, wl.path_mat)
    np.testing.assert_array_equal(ours.pkt_ts, wl.pkt_ts)
    assert ours.paths() == wl.paths
    rep = Replayer(wl, 20)
    for e in range(SPEC["n_epochs"]):
        theirs = rep.epoch_stream(e)
        assert set(ours.streams[e]) == set(theirs)
        for sw, (k, ts, sh) in ours.streams[e].items():
            np.testing.assert_array_equal(k, theirs[sw].keys)
            np.testing.assert_array_equal(ts, theirs[sw].ts)
            np.testing.assert_array_equal(sh, theirs[sw].single_hop)


def test_one_seed_one_trace_and_the_seed_reaches_it():
    a, b, c = make_trace(SPEC, 11), make_trace(SPEC, 11), make_trace(SPEC, 12)
    np.testing.assert_array_equal(a.pkt_ts, b.pkt_ts)
    assert not np.array_equal(a.keys, c.keys)
    # every seed draws the same flow sizes, in another order
    np.testing.assert_array_equal(np.sort(a.sizes), np.sort(c.sizes))
    assert a.events() == sum(len(s[0]) for ep in a.streams
                             for s in ep.values())
    assert a.packets_in(range(SPEC["n_epochs"])) == len(a.pkt_ts)


@pytest.mark.parametrize("name", ["disketch-cs-s61", "disketch-um-s61"])
def test_config_memories_are_the_gini_draw(name):
    cfg = json.loads((ROOT / f"perfbench/configs/{name}.json").read_text())
    mem = gini_memories(cfg["n_switches"], cfg["base_memory_bytes"],
                        cfg["gini"], np.random.RandomState(cfg["memory_seed"]))
    assert mem.tolist() == cfg["memories_bytes"]
