"""The aggregated baselines of the port (``core/sketches.py`` and
``AggregatedSystem``) on the CPU, against the JAX package's numpy
versions: counters ``np.array_equal``, estimates and entropies within
1e-12 relative (the port gathers and merges in float64)."""
import numpy as np
import pytest
import torch

from repro.core import sketches as RS
from repro.core.disketch import AggregatedSystem as RAggregated
from repro.net.simulator import Replayer as RReplayer
from repro.net.topology import FatTree as RFatTree
from repro.net.topology import core_on_path as r_core_on_path
from repro.net.traffic import gen_workload as r_gen_workload
from repro_torch.core import sketches as S
from repro_torch.core.disketch import AggregatedSystem
from repro_torch.net.simulator import Replayer
from repro_torch.net.topology import FatTree, core_on_path
from repro_torch.net.traffic import gen_workload

REL = 1e-12
WL_KW = dict(n_flows=3000, total_packets=40_000, n_epochs=3, log2_te=12,
             burstiness=0.2, seed=9)


def _stream(seed, n=20_000, n_keys=3000):
    rng = np.random.RandomState(seed)
    universe = rng.randint(0, 2 ** 32, n_keys, dtype=np.int64).astype(
        np.uint32)
    keys = universe[rng.zipf(1.3, n) % n_keys]
    values = rng.randint(-3, 9, n).astype(np.int64)
    return universe, keys, values


def _entropy_np(x):
    return x * np.log2(np.maximum(x, 1.0))


@pytest.mark.parametrize("kind,depth,width", [("cs", 4, 1000),
                                              ("cs", 3, 77),
                                              ("cms", 4, 1000),
                                              ("cms", 5, 70_001)])
def test_update_and_query_match_reference(kind, depth, width):
    """Two batches into one matrix sketch (widths above 65536 keep the
    reference's hash wrap), then point queries of every key: even and odd
    depths take the median's two branches."""
    universe, keys, values = _stream(depth * width)
    spec, rspec = (S.SketchSpec(kind, depth, width, seed=3),
                   RS.SketchSpec(kind, depth, width, seed=3))
    got = S.make_counters(spec, device="cpu")
    want = RS.make_counters(rspec)
    for part in (slice(0, 7000), slice(7000, None)):
        got = S.update(spec, got, keys[part], values[part])
        want = RS.update(rspec, want, keys[part], values[part])
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(S.query(spec, got, universe),
                               RS.query(rspec, want, universe), rtol=REL)
    assert S.query(spec, got, universe[:0]).shape == (0,)


def test_univmon_matches_reference():
    """UnivMon: the level stack's counters, level-0 frequencies, the G-sum
    (whose k_heavy binds at the lower levels) and the entropy."""
    universe, keys, values = _stream(1, n=30_000)
    values = np.abs(values) + 1
    spec, rspec = (S.UnivMonSpec(4, 256, n_levels=8, seed=2),
                   RS.UnivMonSpec(4, 256, n_levels=8, seed=2))
    got = S.um_update(spec, S.um_make_counters(spec, device="cpu"), keys,
                      values)
    want = RS.um_update(rspec, RS.um_make_counters(rspec), keys, values)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(S.um_query_freq(spec, got, universe),
                               RS.um_query_freq(rspec, want, universe),
                               rtol=REL)
    for k_heavy in (64, 4096):
        assert S.um_gsum(spec, got, universe, _entropy_np,
                         k_heavy=k_heavy) == pytest.approx(
            RS.um_gsum(rspec, want, universe, _entropy_np,
                       k_heavy=k_heavy), rel=REL)
    total = float(values.sum())
    assert S.um_entropy(spec, got, universe, total) == pytest.approx(
        RS.um_entropy(rspec, want, universe, total), rel=REL)
    assert S.um_entropy(spec, got, universe, 0.0) == 0.0
    sizes = np.bincount(np.searchsorted(np.sort(universe), keys))
    assert S.true_entropy(sizes) == RS.true_entropy(sizes)


@pytest.fixture(scope="module")
def trace():
    wl = r_gen_workload(RFatTree(4), **WL_KW)
    sel = wl.path_len == 5
    return wl, RReplayer(wl, 20), sel


@pytest.mark.parametrize("kind", ["cs", "cms", "um"])
def test_aggregated_system_matches_reference(trace, kind):
    """A full sketch on each core switch, replayed epoch by epoch: every
    epoch's counters equal the reference's, and the 5-hop flows' window
    estimates at their core switch agree to 1e-12."""
    rwl, rrep, sel = trace
    topo = FatTree(4)
    mems = {sw: 8 * 1024 * (1 + sw % 3) for sw in topo.core_ids}
    agg = AggregatedSystem(mems, kind, depth=4, n_levels=8, device="cpu")
    ref = RAggregated(mems, kind, depth=4, n_levels=8)
    wl = gen_workload(topo, **WL_KW)
    Replayer(wl, topo.n_switches).run(agg)
    rrep.run(ref)
    for e in range(WL_KW["n_epochs"]):
        for sw in mems:
            np.testing.assert_array_equal(agg.counters[e][sw].numpy(),
                                          ref.counters[e][sw])
    core = core_on_path(wl.path_mat[sel], topo.core_ids)
    np.testing.assert_array_equal(
        core, r_core_on_path(rwl.path_mat[sel], RFatTree(4).core_ids))
    epochs = list(range(WL_KW["n_epochs"]))
    np.testing.assert_allclose(agg.query_flows(wl.keys[sel], core, epochs),
                               ref.query_flows(rwl.keys[sel], core, epochs),
                               rtol=REL)


def test_aggregated_system_refusals():
    """Unprocessed epochs raise ``KeyError``, churn events ``ValueError``,
    and without a card the default device raises instead of falling back
    to the CPU."""
    agg = AggregatedSystem({16: 4096}, "cms", device="cpu")
    agg.run_epoch(0, {})
    assert agg.query_flows(np.arange(3, dtype=np.uint32), [16] * 3,
                           [0]).tolist() == [0.0, 0.0, 0.0]
    with pytest.raises(KeyError, match=r"\[1\]"):
        agg.query_flows(np.arange(3, dtype=np.uint32), [16] * 3, [0, 1])
    with pytest.raises(ValueError, match="churn"):
        agg.run_epoch(1, {}, events=[object()])
    assert 1 not in agg.counters
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            AggregatedSystem({16: 4096}, "cs")
