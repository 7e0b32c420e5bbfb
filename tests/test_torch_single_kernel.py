"""The port's single-fragment update (``ops.sketch_update``, kernel B2's
wrapper) on the CPU against the JAX package.

On CPU tensors the wrapper runs its plain PyTorch version.  Counters must
equal, bit for bit (``array_equal``), both of the reference's plain paths:
its jnp scatter oracle ``sketch_update(backend="ref")`` (no Pallas) and
its per-switch numpy update ``process_epoch``.  Cases cover cs and cms,
UnivMon level rows and §4.4 mitigation on folded timestamps, widths up to
262144 (above the 65536 hash wrap), ``n_sub`` up to 256, and packet
counts that are not multiples of ``blk``.  The kernel's launch geometry
(``single_geometry``) and its padding are pure Python and are tested here
too: the plain version run CTA share by CTA share sums to the reference.
The CUDA kernel is held to the same plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import math

import numpy as np
import pytest
import torch

from repro.core import fleet as RF
from repro.core.fragment import FragmentConfig as RCfg
from repro.core.fragment import frag_seed, level_seed_mix, process_epoch
from repro.kernels.sketch_update import ops as RO
from repro_torch.kernels.sketch_update import ops as TO
from repro_torch.kernels.sketch_update.kernel import (EXACT_BOUND,
                                                      LVL_SHIFT, SH_SHIFT)

LOG2_TE = 12
EPOCH = 3


def _stream(n, seed, n_flows=3000):
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.3, n) % n_flows).astype(np.uint32) \
        * np.uint32(2654435761)
    vals = rng.integers(1, 4, n).astype(np.int64)
    ts = rng.integers(0, 1 << LOG2_TE, n) + (EPOCH << LOG2_TE)
    return keys, vals, ts, rng.random(n) < 0.3


SINGLE_CASES = {
    # kind, width, n_sub, n_packets, blk, extra FragmentConfig settings
    "cs-narrow": ("cs", 300, 1, 1000, 256, {}),
    "cs-wrap-70000": ("cs", 70_000, 4, 5003, 256, {}),
    "cs-262144": ("cs", 262_144, 16, 4099, 512, {}),
    "cms-n256": ("cms", 3728, 256, 6007, 256, {}),
    "cms-blk1000": ("cms", 8335, 8, 2500, 1000, {}),
    "cs-mitigation": ("cs", 4000, 8, 4001, 256, dict(mitigation=True)),
    "um4": ("um", 2000, 4, 5000, 256, dict(n_levels=4)),
    "um4-mitigation": ("um", 2000, 2, 3001, 128,
                       dict(n_levels=4, mitigation=True)),
}


@pytest.mark.parametrize("name", sorted(SINGLE_CASES))
def test_single_update_matches_reference(name):
    kind, width, n_sub, n, blk, cfg_kw = SINGLE_CASES[name]
    L = cfg_kw.get("n_levels", 1)
    mit = cfg_kw.get("mitigation", False)
    keys, vals, ts, sh = _stream(n, sum(map(ord, name)))
    cfg = RCfg(7, kind, 4 * width * L, **cfg_kw)
    assert cfg.width == width
    rec = process_epoch(cfg, EPOCH, n_sub, keys, vals, ts, EPOCH << LOG2_TE,
                        LOG2_TE, single_hop=sh)
    want_rows = rec.counters if kind == "um" else rec.counters[None]
    # ts with the packer's folded level id / single-hop bit
    packet = RF.fold_packet_flags(
        RF.FleetPacket(keys, vals, ts, np.array([0, n]), (7,), sh),
        LOG2_TE, n_levels=L, level_seed=cfg.level_seed, mitigation=mit)
    fts = np.asarray(packet.ts, np.uint32)
    col = frag_seed(7, EPOCH, 0x1000)
    sgn = frag_seed(7, EPOCH, 0x2000)
    sub = frag_seed(7, EPOCH, 0x3000)
    for lvl in range(L):
        kw = dict(width=width, n_sub=n_sub, log2_te=LOG2_TE,
                  col_seed=level_seed_mix(col, lvl) if kind == "um" else col,
                  sign_seed=level_seed_mix(sgn, lvl) if kind == "um" else sgn,
                  sub_seed=sub, signed=kind != "cms", level=lvl,
                  mitigation=mit)
        got = TO.sketch_update(keys, vals.astype(np.float32), fts,
                               device="cpu", blk=blk, **kw)
        assert got.shape == (n_sub, width) and got.dtype == torch.float32
        ref = np.asarray(RO.sketch_update(keys, vals.astype(np.float32), fts,
                                          backend="ref", **kw))
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(got.numpy(), want_rows[lvl])
        # tensor inputs (uint32 words as int32 bits) give the same counters
        same = TO.sketch_update(
            torch.from_numpy(keys.view(np.int32).copy()),
            torch.from_numpy(vals.astype(np.float32)),
            torch.from_numpy(fts.view(np.int32).copy()), blk=blk, **kw)
        assert torch.equal(same, got)
        assert torch.equal(TO.sketch_update(keys, vals.astype(np.float32),
                                            fts, device="cpu",
                                            backend="ref", **kw), got)


def test_overflow_guard_and_argument_checks():
    n = 300
    keys = np.full(n, 12345, np.uint32)
    ts = np.zeros(n, np.uint32)
    vals = np.full(n, EXACT_BOUND // 100, np.float32)   # one hot counter
    kw = dict(width=64, n_sub=1, log2_te=LOG2_TE, col_seed=1, sign_seed=2,
              sub_seed=3, signed=False, device="cpu")
    with pytest.raises(OverflowError, match="2\\^24"):
        TO.sketch_update(keys, vals, ts, **kw)
    with pytest.raises(OverflowError):
        TO.sketch_update(keys, vals, ts, backend="ref", **kw)
    with pytest.raises(OverflowError):          # the reference agrees
        RO.sketch_update(keys, vals, ts, backend="ref",
                         **{k: v for k, v in kw.items() if k != "device"})
    out = TO.sketch_update(keys, vals, ts, check_overflow=False, **kw)
    assert float(out.max()) == float(vals.sum())
    small = vals[:10] // 1000
    with pytest.raises(ValueError, match="backend"):
        TO.sketch_update(keys[:10], small, ts[:10], backend="pallas", **kw)
    with pytest.raises(ValueError, match="power of two"):
        TO.sketch_update(keys[:10], small, ts[:10],
                         **dict(kw, n_sub=3))
    with pytest.raises(ValueError, match="log2_te"):
        TO.sketch_update(keys[:10], small, ts[:10],
                         **dict(kw, n_sub=1 << (LOG2_TE + 1)))
    with pytest.raises(ValueError, match="inputs on cpu"):
        TO.sketch_update(torch.zeros(4, dtype=torch.int32), torch.zeros(4),
                         torch.zeros(4, dtype=torch.int32),
                         **dict(kw, device="cuda"))
    with pytest.raises(TypeError):
        TO.sketch_update(torch.zeros(4, dtype=torch.int64), torch.zeros(4),
                         torch.zeros(4, dtype=torch.int32), **kw)


def test_empty_stream_and_padding_packets():
    """No packets, or only value-0 padding, give exact zeros."""
    kw = dict(width=100, n_sub=4, log2_te=LOG2_TE, col_seed=1, sign_seed=2,
              sub_seed=3, device="cpu")
    empty = np.zeros(0, np.uint32)
    out = TO.sketch_update(empty, np.zeros(0, np.float32), empty, **kw)
    assert out.shape == (4, 100) and not out.any()
    keys = np.arange(1, 600, dtype=np.uint32)
    out = TO.sketch_update(keys, np.zeros(len(keys), np.float32),
                           keys.copy(), **kw)
    assert not out.any()


def test_default_device_is_cuda():
    """Numpy inputs go to the card unless the caller names another
    device; without a card that raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    keys = np.arange(10, dtype=np.uint32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TO.sketch_update(keys, np.ones(10, np.float32), keys, width=8,
                         n_sub=1, log2_te=LOG2_TE, col_seed=1, sign_seed=2,
                         sub_seed=3)


def test_padding_does_not_change_counters():
    """The value-0 padding contract: any ``blk`` gives the same counters,
    and §4.4 mitigation at ``n_sub = 1`` is a no-op, as in the reference
    (the second subepoch is the first)."""
    keys, vals, ts, _ = _stream(3001, 9)
    ts = ts | (1 << 31)                 # every packet flagged single-hop
    kw = dict(width=5000, n_sub=1, log2_te=LOG2_TE, col_seed=1,
              sign_seed=2, sub_seed=3, device="cpu")
    vals = vals.astype(np.float32)
    outs = [TO.sketch_update(keys, vals, ts, blk=blk, **kw)
            for blk in (1, 128, 256, 1000, 4096)]
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert torch.equal(TO.sketch_update(keys, vals, ts, mitigation=True,
                                        **kw), outs[0])


@pytest.mark.parametrize("n_packets", [0, 4, 777, 1024, 32_768, 300_001])
def test_single_geometry_covers_every_slot_once(n_packets):
    """Kernel B2's launch: thread ``i`` of CTA ``c`` loads slots ``[4 q,
    4 q + 4)``, ``q = c * CTA_THREADS + i``.  Every slot of the stream lies
    in exactly one load, no CTA holds only slots past the end, and a grid
    past CUDA's limit raises."""
    threads = TO.CTA_THREADS
    grid = TO.single_geometry(n_packets)
    q = np.arange(grid * threads, dtype=np.int64)
    slots = (4 * q[:, None] + np.arange(4)).ravel()
    np.testing.assert_array_equal(slots[slots < n_packets],
                                  np.arange(n_packets))
    assert (grid == 0 if n_packets == 0
            else 4 * (grid - 1) * threads < n_packets)
    with pytest.raises(ValueError, match="grid limit"):
        TO.single_geometry(4 * threads * 2 ** 31 + n_packets)


SHARE_CASES = {
    # kind, width, n_sub, level, mitigation
    "cs": ("cs", 70_000, 4, 0, False),
    "cms": ("cms", 3728, 8, 0, False),
    "um-level3": ("um", 2000, 4, 3, False),
    "cs-mit": ("cs", 4000, 8, 0, True),
}


@pytest.mark.parametrize("name", sorted(SHARE_CASES))
def test_single_chunk_shares_sum_to_reference_oracle(name):
    """The kernel's cut of the stream: the plain version run over each
    CTA's share (``CTA_THREADS x 4`` slots) and summed over the shares equals
    the reference's oracle bit for bit.  Counters are integer sums below
    2^24, so the order in which the CTAs' atomics land changes no bit."""
    kind, width, n_sub, level, mit = SHARE_CASES[name]
    n = 6007
    keys, vals, ts, sh = _stream(n, sum(map(ord, name)))
    rng = np.random.default_rng(len(name))
    fts = (ts.astype(np.uint32)
           | (rng.integers(0, 6, n).astype(np.uint32) << LVL_SHIFT)
           | (sh.astype(np.uint32) << SH_SHIFT))
    vals = vals.astype(np.float32)
    kw = dict(width=width, n_sub=n_sub, log2_te=LOG2_TE, col_seed=11,
              sign_seed=22, sub_seed=33, signed=kind != "cms", level=level,
              mitigation=mit)
    want = np.asarray(RO.sketch_update(keys, vals, fts, backend="ref", **kw))
    grid = TO.single_geometry(n)
    share = 4 * TO.CTA_THREADS
    assert grid == -(-n // share) > 1
    total = torch.zeros((n_sub, width), dtype=torch.float32)
    for c in range(grid):
        part = slice(c * share, (c + 1) * share)
        total += TO.sketch_update(keys[part], vals[part], fts[part],
                                  backend="ref", device="cpu", **kw)
    np.testing.assert_array_equal(total.numpy(), want)
    assert want.any()


@pytest.mark.parametrize("blk", [1000, 1001])
def test_padding_to_four_for_any_blk(blk, monkeypatch):
    """The wrapper pads the stream with value-0 packets to a multiple of
    both ``blk`` and 4 (the kernel's 16-byte load), whatever ``blk`` the
    caller gives, as the reference accepts any; the padding changes no
    counter."""
    seen = []
    plain = TO.sketch_update_ref

    def spy(keys, vals, ts, **kw):
        seen.append(keys.shape[0])
        return plain(keys, vals, ts, **kw)

    monkeypatch.setattr(TO, "sketch_update_ref", spy)
    n = 2503
    keys, vals, ts, _ = _stream(n, blk)
    vals = vals.astype(np.float32)
    kw = dict(width=3000, n_sub=2, log2_te=LOG2_TE, col_seed=1, sign_seed=2,
              sub_seed=3)
    got = TO.sketch_update(keys, vals, ts, blk=blk, device="cpu", **kw)
    (padded,) = seen
    assert padded % 4 == 0 and padded % blk == 0
    assert 0 <= padded - n < math.lcm(blk, 4)
    want = np.asarray(RO.sketch_update(keys, vals, ts, backend="ref",
                                       blk=blk, **kw))
    np.testing.assert_array_equal(got.numpy(), want)
    unpadded = plain(torch.from_numpy(keys.view(np.int32).copy()),
                     torch.from_numpy(vals),
                     torch.from_numpy(ts.astype(np.uint32).view(np.int32)),
                     signed=True, **kw)
    assert torch.equal(got, unpadded)
