"""Parity of the port's host packer with the JAX package's (pure numpy on
both sides): ``pack_streams``, ``fold_packet_flags``, ``pack_csr`` and
``build_params`` must give equal arrays; the stream every device builds
from one staging of the window (``csr_streams``, here with the scatter's
plain version) must equal ``pack_csr``'s, bit for bit; and a window run on
the CPU must equal one fed ``pack_csr``'s streams."""
import numpy as np
import pytest
import torch

from repro.core import fleet as RF
from repro.core.disketch import SwitchStream as RStream
from repro.core.fragment import FragmentConfig as RCfg
from repro_torch import obs
from repro_torch.core import fleet as TF
from repro_torch.core.disketch import DiSketchSystem
from repro_torch.core.disketch import SwitchStream as TStream
from repro_torch.core.fragment import FragmentConfig as TCfg
from repro_torch.launch import make_switch_mesh
from repro_torch.net.simulator import Replayer
from repro_torch.net.topology import FatTree
from repro_torch.net.traffic import gen_workload
from torch_threads import one_thread  # noqa: F401

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


# The window's stream built from one staging of the raw packets
# (``csr_streams``: ``stage_packets``, ``csr_row_tables`` and the plain
# ``csr_scatter_ref``; a CUDA kernel on a card) against ``pack_csr`` of each
# row group's selected fragments.  Besides CONFIGS' skewed segments, empty
# switch (3), missing switch (11), folded UnivMon levels and §4.4 flags:
# masked (value-0) fragments, and at blk = 8 block counts past
# ``_bucket_blocks``' floor, so the trailing bucket blocks are padded too.
STAGED = [(*c, ()) for c in CONFIGS] + [("cs", 16, False, (0, 3)),
                                         ("um", 4, True, (2,))]


STAGED_IDS = [f"{k}{n}{'-mit' if m else ''}{'-masked' if d else ''}"
              for k, n, m, d in STAGED]


def _staged_packets(kind, n_levels, mitigation, masked, fold=True):
    """The window's masked packets, folded by ``fold_packet_flags`` (or,
    with ``fold=False``, as the epoch packs them)."""
    order = tuple(sorted(MEMS))
    L = n_levels if kind == "um" else 1
    packets = [TF.mask_fragment_values(
        TF.pack_streams(_streams(TStream, e, e), order), masked)
        for e in (5, 6, 7)]
    if not fold:
        return packets
    return [TF.fold_packet_flags(p, LOG2_TE, n_levels=L, level_seed=7777,
                                 mitigation=mitigation) for p in packets]


@pytest.mark.parametrize("kind,n_levels,mitigation,masked", STAGED,
                         ids=STAGED_IDS)
@pytest.mark.parametrize("blk", [8, 256])
def test_staged_csr_streams_match_pack_csr(kind, n_levels, mitigation,
                                          masked, blk):
    _check_staged_streams(kind, n_levels, mitigation, masked, blk,
                          on_scatter=False)


@pytest.mark.parametrize("kind,n_levels,mitigation,masked", STAGED,
                         ids=STAGED_IDS)
@pytest.mark.parametrize("blk", [8, 256])
def test_staged_csr_streams_fold_levels_as_fold_packet_flags(
        kind, n_levels, mitigation, masked, blk):
    """The same windows handed to ``csr_streams`` unfolded, with the fold's
    arguments, as ``dispatch_ragged_grouped`` hands them on a card: the
    scatter folds each key's UnivMon level, except under §4.4 mitigation,
    where the host folds the whole word and the scatter gets one level.
    Each stream equals ``fold_packet_flags`` + ``pack_csr`` bit for bit,
    and the ``folded`` counts add up to the packets the scatter folded."""
    _check_staged_streams(kind, n_levels, mitigation, masked, blk,
                          on_scatter=True)


def _check_staged_streams(kind, n_levels, mitigation, masked, blk,
                          on_scatter):
    folded = _staged_packets(kind, n_levels, mitigation, masked)
    packets, fold = folded, {}
    if on_scatter and not mitigation:
        packets = _staged_packets(kind, n_levels, mitigation, masked,
                                  fold=False)
        fold = dict(log2_te=LOG2_TE, level_seed=7777,
                    n_levels=n_levels if kind == "um" else 1)
    nsub = np.array([NS[sw] for sw in sorted(MEMS)])
    idxs = [np.flatnonzero(nsub == n) for n in np.unique(nsub)]
    cpu = torch.device("cpu")
    obs.clear()
    got = TF.csr_streams(packets, [(cpu, idx) for idx in idxs], blk, **fold)
    assert len(got) == len(idxs) == 4
    padded = 0
    for idx, (keys, vals, ts, bf) in zip(idxs, got):
        want = TF.pack_csr([p.select(idx) for p in folded], blk)
        rows, bf_t = TF.csr_row_tables(packets, idx, blk)
        assert rows.shape == (3, 3 * len(idx)) and rows.dtype == np.int64
        np.testing.assert_array_equal(bf_t, want[3])
        assert bf.dtype == want[3].dtype == np.int32
        np.testing.assert_array_equal(bf, want[3])
        for t, w in zip((keys, vals, ts), want[:3]):
            assert t.dtype == (torch.float32 if w.dtype == np.float32
                               else torch.int32)
            np.testing.assert_array_equal(t.numpy().view(w.dtype), w)
            np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                          w.view(np.uint32))
        live = -(-rows[1] // blk)
        padded += len(bf) > np.maximum(live, 1).sum() > 32
    assert padded or blk == 256
    names = [s.name for s in obs.spans()]
    assert names.count("fleet.pack_csr") == 1 + len(idxs)
    assert names.count("fleet.upload") == 1
    n_folded = [s.counts["folded"] for s in obs.spans()
                if s.name == "fleet.pack_csr"
                and "launches" in (s.counts or {})]
    assert len(n_folded) == len(idxs)
    live = sum(len(p.keys) for p in packets)
    assert sum(n_folded) == (live if fold.get("n_levels", 1) > 1 else 0)


def _key_hashing_to(h, seed):
    """The uint32 key whose ``hash_u32(key, seed)`` is ``h``: the hash is a
    bijection (an odd multiplier, an add, and splitmix32's invertible
    finalizer), so it is run backwards."""
    m32 = 0xFFFFFFFF

    def unshift(x, k):          # inverse of x ^ (x >> k)
        y = x
        for _ in range(32 // k + 1):
            y = x ^ (y >> k)
        return y & m32

    x = unshift(h, 16)
    x = (x * pow(0x846CA68B, -1, 1 << 32)) & m32
    x = unshift(x, 15)
    x = (x * pow(0x7FEB352D, -1, 1 << 32)) & m32
    x = unshift(x, 16)
    return ((x - seed) * pow(2654435769, -1, 1 << 32)) & m32


@pytest.mark.parametrize("n_levels", [2, 16, 32])
def test_csr_scatter_ref_folds_levels_as_level_of(n_levels):
    """The scatter's plain version folds each live slot's ts to
    ``(ts & te_mask) | level_of(key) << LVL_SHIFT`` and leaves the padding
    zero: on keys 0 and 0xFFFFFFFF, on keys whose ``n_levels - 1`` sampling
    bits are all set (level ``n_levels - 1``), or all but the top one
    (``n_levels - 2``) or the lowest one (0), and on random keys."""
    from repro_torch.core import hashing as H
    from repro_torch.kernels.sketch_update import fleet as FK

    seed, log2_te, blk = 7777, 16, 8
    mask = (1 << (n_levels - 1)) - 1
    edge = [_key_hashing_to(h, seed) for h in (
        mask, 0xFFFFFFFF, mask ^ (1 << (n_levels - 2)), mask ^ 1,
        0xFFFFFFFF ^ mask)]
    assert H.hash_u32(np.array(edge, np.uint32), seed).tolist() == [
        mask, 0xFFFFFFFF, mask ^ (1 << (n_levels - 2)), mask ^ 1,
        0xFFFFFFFF ^ mask]
    rng = np.random.default_rng(n_levels)
    keys = np.concatenate([np.array([0, 0xFFFFFFFF] + edge, np.uint32),
                           rng.integers(0, 1 << 32, 993, np.uint64)
                           .astype(np.uint32)])
    ts = rng.integers(0, 1 << 32, len(keys), np.uint64).astype(np.int64)
    packet = TF.FleetPacket(keys, rng.integers(1, 4, len(keys)), ts,
                            np.array([0, 597, len(keys)], np.int64), (0, 1))
    want = TF.pack_csr([TF.fold_packet_flags(
        packet, log2_te, n_levels=n_levels, level_seed=seed)], blk)
    rows, bf = TF.csr_row_tables([packet], np.arange(2), blk)
    staged = TF.stage_packets([packet])
    got = FK.csr_scatter_ref(staged[0], staged[1].view(torch.float32),
                             staged[2], torch.from_numpy(rows),
                             torch.from_numpy(bf.astype(np.int64)), blk=blk,
                             log2_te=log2_te, n_levels=n_levels,
                             level_seed=seed)
    for t, w in zip(got, want[:3]):
        np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                      w.view(np.uint32))
    lvl = got[2].numpy().view(np.uint32)[:len(edge) + 2] >> 24
    assert lvl.tolist() == H.level_of(keys[:len(edge) + 2], seed,
                                      n_levels).tolist()
    assert lvl[2:5].tolist() == [n_levels - 1, n_levels - 1,
                                 max(n_levels - 2, 0)]
    assert lvl[5:7].tolist() == [0, 0]
    assert not got[2].numpy()[597:600].any()     # row 0's padding


def test_csr_scatter_refuses_a_fold_it_cannot_make():
    from repro_torch.kernels.sketch_update import fleet as FK

    keys = torch.zeros(8, dtype=torch.int32)
    args = (keys, keys.float(), keys,
            torch.tensor([[0], [8], [0]]), torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="n_levels=33"):
        FK.csr_scatter(*args, blk=8, n_levels=33)
    with pytest.raises(ValueError, match="log2_te"):
        FK.csr_scatter(*args, blk=8, log2_te=25, n_levels=16)
    FK.csr_scatter(*args, blk=8, log2_te=25)     # nothing to fold: a copy


# A mesh's shards as ``dispatch_ragged_grouped`` forms its row groups:
# ``((lo, hi), device)`` blocks of fragment positions.  ``cpu`` and
# ``cpu:0`` are two devices to torch, so each stands for one card.
MESHES = {"halves": [((0, 2), "cpu"), ((2, 5), "cpu:0")],
          "two_shards_one_device": [((0, 2), "cpu"), ((2, 4), "cpu"),
                                    ((4, 5), "cpu:0")]}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind,n_levels,mitigation,masked", STAGED,
                         ids=STAGED_IDS)
def test_csr_streams_send_each_device_only_its_fragments(
        kind, n_levels, mitigation, masked, mesh):
    """On a mesh each device is sent the packets of its own shards' span
    of fragments and its groups' tables, once a window, so every packet
    crosses to one device only; each group's stream is ``pack_csr``'s."""
    packets = _staged_packets(kind, n_levels, mitigation, masked)
    nsub = np.array([NS[sw] for sw in sorted(MEMS)])
    groups = [(torch.device(dev), lo + np.flatnonzero(nsub[lo:hi] == n))
              for (lo, hi), dev in MESHES[mesh]
              for n in np.unique(nsub[lo:hi])]
    obs.clear()
    got = TF.csr_streams(packets, groups, 8)
    for (_, idx), (keys, vals, ts, bf) in zip(groups, got):
        want = TF.pack_csr([p.select(idx) for p in packets], 8)
        np.testing.assert_array_equal(bf, want[3])
        for t, w in zip((keys, vals, ts), want[:3]):
            np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                          w.view(np.uint32))
    sent = [s.counts["bytes"] for s in obs.spans() if s.name == "fleet.upload"]
    want_sent, staged = [], 0
    for dev in dict.fromkeys(d for d, _ in groups):
        mine = [j for j, (d, _) in enumerate(groups) if d == dev]
        idx = np.concatenate([groups[j][1] for j in mine])
        lo, hi = int(idx.min()), int(idx.max()) + 1
        n_pkts = sum(int(p.offsets[hi] - p.offsets[lo]) for p in packets)
        n_blocks = sum(len(got[j][3]) for j in mine)
        want_sent.append(12 * n_pkts
                         + 8 * (3 * len(packets) * len(idx) + n_blocks))
        staged += n_pkts
    assert sent == want_sent and len(sent) == 2
    assert staged == sum(len(p.keys) for p in packets)


# ``DiSketchSystem.run_window`` on the CPU, whose streams the scatter's
# plain version builds: (kind, mitigation, shards).
RUNS = [("cs", False, 1), ("cms", False, 1), ("um", False, 1),
        ("um", True, 1), ("um", False, 2)]


def _window_run(kind, mitigation, shards, wl):
    where = (dict(device="cpu") if shards == 1 else
             dict(mesh=make_switch_mesh(shards, devices=["cpu"] * shards)))
    system = DiSketchSystem({sw: 32 * 1024 for sw in range(20)}, kind,
                            rho_target=4.0, log2_te=LOG2_TE, n_levels=16,
                            mitigation=mitigation, **where)
    for sw in range(20):
        system.ns[sw] = (1, 2, 4)[sw % 3]
    rep = Replayer(wl, 20)
    for e0 in (0, 4):            # the second window at Eq. 6's own ns
        system.run_window(e0, [rep.epoch_stream(e)
                               for e in range(e0, e0 + 4)])
    return system


@pytest.mark.parametrize("kind,mitigation,shards", RUNS,
                         ids=[f"{k}{'-mit' if m else ''}-x{s}"
                              for k, m, s in RUNS])
def test_run_window_equals_a_run_fed_pack_csr(kind, mitigation, shards,
                                              monkeypatch):
    """A window run on the CPU gives every cell's counters, the Eq. 6
    trajectory and the PEBs of a run whose streams ``fold_packet_flags``,
    ``select`` and ``pack_csr`` build on the host, bit for bit: Count
    Sketch, Count-Min, UnivMon (16 levels, level seed 7777) with and
    without §4.4 mitigation, and UnivMon on a two-shard mesh."""
    wl = gen_workload(FatTree(4), n_flows=1500, total_packets=20_000,
                      n_epochs=8, log2_te=LOG2_TE, burstiness=0.2, seed=11)
    staged = _window_run(kind, mitigation, shards, wl)
    with monkeypatch.context() as m:
        m.setattr(TF, "csr_streams", lambda packets, groups, blk, **fold: [
            TF.pack_csr([TF.fold_packet_flags(p, **fold).select(idx)
                         for p in packets], blk)
            for _, idx in groups])
        packed = _window_run(kind, mitigation, shards, wl)
    assert len({n for ns in staged.n_log for n in ns.values()}) > 1
    assert staged.n_log == packed.n_log
    assert staged.peb_log == packed.peb_log
    for e in range(8):
        for sw in range(20):
            assert np.array_equal(staged.fleet.cell_counters(e, sw),
                                  packed.fleet.cell_counters(e, sw)), (e, sw)
