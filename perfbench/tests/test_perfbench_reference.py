"""The plain reference against the port's plain path (``device="cpu"``)
at a small size: counters, PEBs and the Eq. 6 trajectory of every window,
flow estimates and entropies."""
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench.gen.trace import make_trace
from perfbench.harness import _merge
from perfbench.reference.disketch import Fleet, to_bf16
from perfbench.reference.hashing import level_of

from .sizes import SMALL

ROOT = Path(__file__).resolve().parents[2]


def _cfg(name, seed):
    """The configuration at the small size, with ``rho_target`` the median
    PEB of the first epoch (as ``calibrate_rho_target`` sets it), so that
    Eq. 6 moves at this size too."""
    cfg = _merge(json.loads((ROOT / f"perfbench/configs/{name}.json")
                            .read_text()), SMALL)
    probe = Fleet(dict(cfg, rho_target=float("inf")))
    probe.ingest(make_trace(cfg["trace"], seed).streams[:1])
    return dict(cfg, rho_target=float(np.median(probe.pebs[0])))


def _port(cfg, trace):
    from perfbench.systems.disketch import UnderTest

    sut = UnderTest(cfg, trace, "cpu")
    system = sut.new_system()
    E, W = trace.n_epochs, cfg["window"]
    for e0 in range(0, E, W):
        sut.run_window(system, e0, [sut.pack(e) for e in range(e0, e0 + W)])
    return sut, system


@pytest.mark.parametrize("name", ["disketch-cs-s61", "disketch-um-s61"])
def test_window_path_matches(name):
    cfg = _cfg(name, 21)
    trace = make_trace(cfg["trace"], 21)
    sut, system = _port(cfg, trace)
    ref = Fleet(cfg)
    ref.ingest(trace.streams)
    for (e, f), c in ref.counters.items():
        np.testing.assert_array_equal(sut.cell(system, e, f), c)
    assert [[d[f] for f in range(20)] for d in system.n_log] == ref.n_log
    got = np.array([[d[f] for f in range(20)] for d in system.peb_log])
    np.testing.assert_allclose(got, np.array(ref.pebs), rtol=1e-12)
    assert len(set(map(tuple, ref.n_log))) > 1, "Eq. 6 never moved"


def test_flow_estimates_match():
    cfg = _cfg("disketch-cs-s61", 22)
    trace = make_trace(cfg["trace"], 22)
    _, system = _port(cfg, trace)
    ref = Fleet(cfg)
    ref.ingest(trace.streams)
    idx = np.random.default_rng(0).choice(len(trace.keys), 1000, False)
    epochs = list(range(trace.n_epochs))
    got = system.query_flows(trace.keys[idx], [trace.paths()[i] for i in idx],
                             epochs, merge="fragment")
    want = ref.estimates(trace.keys[idx], trace.path_mat[idx], epochs)
    assert set(trace.path_len[idx]) == {1, 3, 5}
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("k_heavy", [16, 1024])
def test_entropy_matches(k_heavy):
    cfg = _cfg("disketch-um-s61", 23)
    trace = make_trace(cfg["trace"], 23)
    _, system = _port(cfg, trace)
    ref = Fleet(cfg)
    ref.ingest(trace.streams, keep=range(4, 8))
    epochs = list(range(4, 8))
    total = float(trace.packets_in(epochs))
    got = system.query_entropy(trace.keys, trace.paths(), epochs, total,
                               n_levels=16, level_seed=7777,
                               k_heavy=k_heavy, merge="fragment")
    want = ref.entropy(trace.keys, trace.path_mat, epochs, total, k_heavy)
    assert abs(got - want) <= 1e-5 * abs(want)


def test_level_of_matches_the_port():
    from repro_torch.core.hashing import level_of as port_level_of

    keys = np.random.default_rng(1).integers(0, 2**32, 10000,
                                             dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(level_of(keys, 7777, 16),
                                  port_level_of(keys, 7777, 16))


def test_bf16_rounding():
    x = np.array([0, 1, 255, 256, 257, 258, 1250, -1251, 3.0e6])
    want = np.array([0, 1, 255, 256, 256, 258, 1248, -1248, 2998272.0])
    np.testing.assert_array_equal(to_bf16(x), want)
