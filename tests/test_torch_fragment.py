"""The §5 cumulative export (``CumulativeFragment``) of the port against the
JAX package: counters are never reset at subepoch boundaries, and the
controller rebuilds each subepoch record as the difference of consecutive
cumulative snapshots.  Its delta records must equal the reset-mode records
(``process_epoch``) and the reference's ``CumulativeFragment``, bit for
bit, over consecutive epochs whose subepoch count changes."""
import numpy as np
import pytest

from repro.core.fragment import CumulativeFragment as RCumulative
from repro.core.fragment import FragmentConfig as RCfg
from repro_torch.core.fragment import (CumulativeFragment, FragmentConfig,
                                       process_epoch)

LOG2_TE = 12

CASES = {
    "cs": dict(kind="cs"),
    "cms": dict(kind="cms"),
    "um": dict(kind="um", n_levels=4),
    "cs-mitigation": dict(kind="cs", mitigation=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_delta_export_equals_reset(name):
    """Over 3 epochs at n = 4, 1, 8, every delta record equals the
    reset-mode record of the same epoch and the reference's delta."""
    kw = CASES[name]
    cfg = FragmentConfig(frag_id=3, memory_bytes=4096, base_seed=1, **kw)
    cum = CumulativeFragment(cfg)
    want = RCumulative(RCfg(frag_id=3, memory_bytes=4096, base_seed=1, **kw))
    rng = np.random.default_rng(7)
    for epoch, n in enumerate((4, 1, 8)):
        m = 500
        keys = rng.integers(0, 200, m).astype(np.uint32)
        vals = rng.integers(1, 5, m).astype(np.int64)
        ts = (epoch << LOG2_TE) + np.sort(rng.integers(0, 1 << LOG2_TE, m))
        hop = rng.random(m) < 0.3
        args = (epoch, n, keys, vals, ts, epoch << LOG2_TE, LOG2_TE)
        got = cum.export_epoch(*args, single_hop=hop)
        reset = process_epoch(cfg, *args, single_hop=hop)
        ref = want.export_epoch(*args, single_hop=hop)
        assert got.n == reset.n == n
        assert got.counters.dtype == np.int64
        np.testing.assert_array_equal(got.counters, reset.counters)
        np.testing.assert_array_equal(got.counters, ref.counters)
        assert got.seeds() == ref.seeds()
    # the switch's single array holds the running sum of every subepoch
    assert cum._cum is not None and np.abs(cum._cum).sum() > 0
    np.testing.assert_array_equal(cum._cum, want._cum)
