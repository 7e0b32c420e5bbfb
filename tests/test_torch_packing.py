"""Parity of the port's host packer with the JAX package's (pure numpy on
both sides): ``pack_streams``, ``fold_packet_flags``, ``pack_csr`` and
``build_params`` must give equal arrays."""
import numpy as np
import pytest

from repro.core import fleet as RF
from repro.core.disketch import SwitchStream as RStream
from repro.core.fragment import FragmentConfig as RCfg
from repro_torch.core import fleet as TF
from repro_torch.core.disketch import SwitchStream as TStream
from repro_torch.core.fragment import FragmentConfig as TCfg

LOG2_TE = 12
MEMS = {0: 4 * 1000, 3: 4 * 70_000, 5: 4 * 300, 9: 4 * 5000, 11: 64}
NS = {0: 1, 3: 2, 5: 8, 9: 2, 11: 4}
# skewed segments, an empty switch, and one with no stream at all
LENS = {0: 3000, 3: 0, 5: 500, 9: 9000}


def _streams(cls, seed=0, epoch=5):
    rng = np.random.default_rng(seed)
    out = {}
    for sw, n in LENS.items():
        keys = (rng.zipf(1.3, n) % 2000).astype(np.uint32) \
            * np.uint32(2654435761)
        out[sw] = cls(keys, rng.integers(1, 4, n).astype(np.int64),
                      rng.integers(0, 1 << LOG2_TE, n) + (epoch << LOG2_TE),
                      rng.random(n) < 0.3)
    return out


def _fleets(kind, n_levels, mitigation):
    kw = dict(n_levels=n_levels, mitigation=mitigation)
    return ({sw: RCfg(sw, kind, m, **kw) for sw, m in MEMS.items()},
            {sw: TCfg(sw, kind, m, **kw) for sw, m in MEMS.items()})


CONFIGS = [("cs", 16, False), ("cms", 16, False), ("um", 4, False),
           ("cs", 16, True), ("um", 4, True)]


@pytest.mark.parametrize("kind,n_levels,mitigation", CONFIGS)
def test_build_params_matches_reference(kind, n_levels, mitigation):
    rfr, tfr = _fleets(kind, n_levels, mitigation)
    order = tuple(sorted(MEMS))
    for epoch in (0, 7):
        np.testing.assert_array_equal(
            TF.build_params(tfr, epoch, NS, order),
            RF.build_params(rfr, epoch, NS, order))


@pytest.mark.parametrize("kind,n_levels,mitigation", CONFIGS)
def test_fold_and_pack_csr_match_reference(kind, n_levels, mitigation):
    order = tuple(sorted(MEMS))
    L = n_levels if kind == "um" else 1
    rps, tps = [], []
    for epoch in (5, 6):
        rp = RF.pack_streams(_streams(RStream, epoch, epoch), order)
        tp = TF.pack_streams(_streams(TStream, epoch, epoch), order)
        for f in ("keys", "values", "ts", "offsets", "single_hop"):
            np.testing.assert_array_equal(getattr(tp, f), getattr(rp, f))
        rps.append(RF.fold_packet_flags(rp, LOG2_TE, n_levels=L,
                                        level_seed=7777,
                                        mitigation=mitigation))
        tps.append(TF.fold_packet_flags(tp, LOG2_TE, n_levels=L,
                                        level_seed=7777,
                                        mitigation=mitigation))
        np.testing.assert_array_equal(tps[-1].ts, rps[-1].ts)
    for blk in (8, 256):
        for got, want in zip(TF.pack_csr(tps, blk), RF.pack_csr(rps, blk)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    idx = np.array([1, 3])
    for f in ("keys", "values", "ts", "offsets", "single_hop"):
        np.testing.assert_array_equal(getattr(tps[0].select(idx), f),
                                      getattr(rps[0].select(idx), f))


@pytest.mark.parametrize("nb", [0, 1, 31, 32, 33, 100, 1000, 12345])
def test_bucket_blocks_matches_reference(nb):
    assert TF._bucket_blocks(nb) == RF._bucket_blocks(nb)


def test_fold_is_a_no_op_without_levels_or_mitigation():
    tp = TF.pack_streams(_streams(TStream), tuple(sorted(MEMS)))
    assert TF.fold_packet_flags(tp, LOG2_TE) is tp
