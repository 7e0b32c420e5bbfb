"""The port's kernel modules on the CPU against the JAX package.

* ``fleet_update_ragged`` on CPU tensors runs its plain PyTorch version;
  it must equal the reference's jnp scatter oracle
  (``fleet_update_loop(backend="ref")``, no Pallas) bit for bit.
* ``peb_fleet_device`` and the device query engine run as torch ops on the
  CPU and are held to the reference's numpy oracles (its jnp engine is
  held to the port in ``test_torch_slice.py``).

The CUDA kernel itself is held to the same plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro.core import equalize as REQ
from repro.core import fleet as RF
from repro.core import query as RQ
from repro.core.disketch import SwitchStream
from repro.core.fragment import FragmentConfig as RCfg
from repro.kernels.sketch_update import fleet as RK
from repro_torch.core import equalize as TEQ
from repro_torch.core import fleet as TF
from repro_torch.core.fragment import FragmentConfig as TCfg
from repro_torch.kernels.sketch_query import engine as TE
from repro_torch.kernels.sketch_update import fleet as TK

LOG2_TE = 12
BLK = 256


def _case(kind, n_levels, mitigation, ns, seed=0):
    """Heterogeneous widths (one above 65536), skewed segments and an
    empty row; returns reference and port packets/params."""
    L = n_levels if kind == "um" else 1
    mems = {0: 4 * 1000 * L, 1: 4 * 70_000 * L, 2: 4 * 300 * L,
            3: 4 * 5000 * L}
    lens = {0: 3000, 1: 0, 2: 500, 3: 7000}
    rng = np.random.default_rng(seed)
    streams = {}
    for sw, n in lens.items():
        keys = (rng.zipf(1.3, n) % 2000).astype(np.uint32) \
            * np.uint32(2654435761)
        streams[sw] = SwitchStream(
            keys, rng.integers(1, 4, n).astype(np.int64),
            rng.integers(0, 1 << LOG2_TE, n) + (5 << LOG2_TE),
            rng.random(n) < 0.3)
    kw = dict(n_levels=n_levels, mitigation=mitigation)
    rfr = {sw: RCfg(sw, kind, m, **kw) for sw, m in mems.items()}
    tfr = {sw: TCfg(sw, kind, m, **kw) for sw, m in mems.items()}
    order = tuple(sorted(mems))
    flags = dict(n_levels=L, level_seed=7777, mitigation=mitigation)
    rp = RF.fold_packet_flags(RF.pack_streams(streams, order), LOG2_TE,
                              **flags)
    tp = TF.fold_packet_flags(TF.pack_streams(streams, order), LOG2_TE,
                              **flags)
    params = TF.build_params(tfr, 5, ns, order)
    return dict(rp=rp, tp=tp, raw=TF.pack_streams(streams, order),
                params=params, L=L,
                n_sub_max=max(ns.values()),
                width_max=max(c.width for c in tfr.values()),
                signed=kind != "cms", rparams=RF.build_params(rfr, 5, ns,
                                                              order))


KERNEL_CASES = {
    "cs": ("cs", 1, False, {0: 1, 1: 2, 2: 8, 3: 2}),
    "cms": ("cms", 1, False, {0: 8, 1: 1, 2: 2, 3: 1}),
    "um4": ("um", 4, False, {0: 1, 1: 2, 2: 8, 3: 2}),
    "cs-mit": ("cs", 1, True, {0: 2, 1: 1, 2: 8, 3: 2}),
    "um4-mit": ("um", 4, True, {0: 2, 1: 2, 2: 1, 3: 8}),
}


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_ragged_update_matches_reference_oracle(name):
    c = _case(*KERNEL_CASES[name])
    np.testing.assert_array_equal(c["params"], c["rparams"])
    keys, vals, ts, block_frag = TF.pack_csr([c["tp"]], BLK)
    kw = dict(n_sub_max=c["n_sub_max"], width_max=c["width_max"],
              log2_te=LOG2_TE, signed=c["signed"])
    before = TK.fleet_update_ragged.launches
    got = TK.fleet_update_ragged(
        keys, vals, ts, c["params"], block_frag, blk=BLK, n_levels=c["L"],
        with_mitigation=KERNEL_CASES[name][2], device="cpu", **kw)
    assert TK.fleet_update_ragged.launches == before   # no kernel on CPU
    dk, dv, dt = c["rp"].densify(BLK)
    want = RK.fleet_update_loop(dk, dv, dt, c["rparams"], backend="ref",
                                **kw)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert np.abs(want).sum() > 0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["cs", "cms", "um4", "um4-mit"])
def test_grouped_dispatch_equals_one_launch(name):
    """Grouping rows by n_sub only changes which zero rows are made.  The
    dispatch takes the packets unfolded and folds each key's level (and,
    with mitigation, its single-hop flag) as ``fold_packet_flags`` does."""
    kind, n_levels, mit, ns = KERNEL_CASES[name]
    c = _case(kind, n_levels, mit, ns, seed=3)
    packets = [c["tp"], c["tp"]]
    params = np.concatenate([c["params"], c["params"]])
    kw = dict(n_sub_max=c["n_sub_max"], width_max=c["width_max"],
              log2_te=LOG2_TE, signed=c["signed"], n_levels=c["L"],
              with_mitigation=mit)
    groups = TF.dispatch_ragged_grouped(params, [c["raw"], c["raw"]],
                                        device="cpu", level_seed=7777,
                                        **{k: v for k, v in kw.items()
                                           if k not in ("n_sub_max",
                                                        "width_max")})
    keys, vals, ts, bf = TF.pack_csr(packets, BLK)
    one = TK.fleet_update_ragged(keys, vals, ts, params, bf, device="cpu",
                                 **kw).reshape(2, -1, c["n_sub_max"],
                                               c["width_max"])
    assert [g.shape[2] for _, g in groups] == sorted(set(ns.values()))
    dense = torch.zeros_like(one)
    for rows, g in groups:
        assert not torch.equal(g, torch.zeros_like(g))
        dense[:, rows, :g.shape[2], :g.shape[3]] = g
    assert torch.equal(dense, one)


def test_wrapper_tensor_inputs_and_validation():
    c = _case(*KERNEL_CASES["cs"])
    keys, vals, ts, bf = TF.pack_csr([c["tp"]], BLK)
    kw = dict(n_sub_max=c["n_sub_max"], width_max=c["width_max"],
              log2_te=LOG2_TE, signed=True)
    a = TK.fleet_update_ragged(keys, vals, ts, c["params"], bf, device="cpu",
                               **kw)
    t = TK.fleet_update_ragged(
        torch.from_numpy(keys.view(np.int32).copy()), torch.from_numpy(vals),
        torch.from_numpy(ts.view(np.int32).copy()),
        torch.from_numpy(c["params"]), torch.from_numpy(bf), **kw)
    assert torch.equal(a, t)
    with pytest.raises(ValueError, match="n_sub"):
        TK.fleet_update_ragged(keys, vals, ts, c["params"], bf,
                               device="cpu", **{**kw, "n_sub_max": 4})
    with pytest.raises(ValueError, match="width"):
        TK.fleet_update_ragged(keys, vals, ts, c["params"], bf,
                               device="cpu", **{**kw, "width_max": 1000})
    bad = bf.copy()
    bad[-1] = 0
    with pytest.raises(ValueError, match="block_frag"):
        TK.fleet_update_ragged(keys, vals, ts, c["params"], bad,
                               device="cpu", **kw)
    with pytest.raises(TypeError):
        TK.fleet_update_ragged(torch.from_numpy(keys.astype(np.int64)), vals,
                               ts, c["params"], bf, **kw)


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """Without a card, asking for CUDA (the default) raises — the port
    never carries on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = _case(*KERNEL_CASES["cs"])
    keys, vals, ts, bf = TF.pack_csr([c["tp"]], BLK)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TK.fleet_update_ragged(keys, vals, ts, c["params"], bf,
                               n_sub_max=8, width_max=70_000,
                               log2_te=LOG2_TE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TF.FleetEpochRunner({0: TCfg(0, "cs", 4000)}, LOG2_TE)


def _ragged_shares(n_blocks, blk):
    """Each CTA's stream blocks, cut as kernel B1 cuts them from
    ``ragged_geometry``."""
    per_cta, grid = TK.ragged_geometry(n_blocks, blk)
    return [range(c * per_cta, min((c + 1) * per_cta, n_blocks))
            for c in range(grid)]


@pytest.mark.parametrize("n_blocks,blk", [
    (0, 256), (1, 256), (3, 256), (4, 256), (5, 256), (1150, 256),
    (4096, 256), (3, 2048), (100, 12), (9, 4)])
def test_ragged_geometry_covers_every_block_once(n_blocks, blk):
    per_cta, grid = TK.ragged_geometry(n_blocks, blk)
    shares = _ragged_shares(n_blocks, blk)
    assert [b for share in shares for b in share] == list(range(n_blocks))
    assert all(len(share) for share in shares)     # no idle CTA
    assert 0 <= grid <= 2 ** 31 - 1 and grid == (n_blocks > 0) * len(shares)
    # one 16-byte load per thread: a CTA walks as many whole blocks as
    # fit CTA_SLOTS slots, and at least one
    assert per_cta == max(1, TK.CTA_SLOTS // blk)
    if n_blocks == 1:
        assert grid == 1


def test_ragged_geometry_refusals():
    for blk in (0, 6, 258):
        with pytest.raises(ValueError, match="multiple of 4"):
            TK.ragged_geometry(8, blk)
    with pytest.raises(ValueError, match="grid limit"):
        TK.ragged_geometry(2 ** 31, 2048)       # one block per CTA
    assert TK.ragged_geometry(2 ** 31, 256) == (4, 2 ** 29)


@pytest.mark.parametrize("name", ["cs", "cms", "um4", "cs-mit"])
def test_cta_shares_sum_to_reference_oracle(name):
    """The plain version over each CTA's share of the stream, as
    ``ragged_geometry`` cuts it, sums to the reference's counters: every
    packet is counted once, and a share that crosses a row boundary reads
    each block's row from ``block_frag``."""
    kind, n_levels, mit, ns = KERNEL_CASES[name]
    c = _case(kind, n_levels, mit, ns, seed=4)
    keys, vals, ts, bf = TF.pack_csr([c["tp"], c["tp"]], BLK)
    params = np.concatenate([c["params"], c["params"]])
    kw = dict(n_sub_max=c["n_sub_max"], width_max=c["width_max"],
              log2_te=LOG2_TE, signed=c["signed"])
    shares = _ragged_shares(len(bf), BLK)
    assert len(shares) > 3 and any(
        bf[s.start] != bf[s.stop - 1] for s in shares)
    total = torch.zeros(len(params), c["n_sub_max"], c["width_max"])
    for s in shares:
        lo, hi = s.start * BLK, s.stop * BLK
        total += TK.fleet_update_ragged_ref(
            *(torch.from_numpy(x[lo:hi].view(np.int32).copy())
              if x.dtype == np.uint32 else torch.from_numpy(x[lo:hi])
              for x in (keys, vals, ts)),
            torch.from_numpy(params), torch.from_numpy(bf[s.start:s.stop]),
            blk=BLK, n_levels=c["L"], with_mitigation=mit, **kw)
    dk, dv, dt = c["rp"].densify(BLK)
    want = RK.fleet_update_loop(dk, dv, dt, c["rparams"], backend="ref",
                                **kw)
    assert np.abs(want).sum() > 0
    for e in range(2):
        np.testing.assert_array_equal(
            total[e * len(c["params"]):(e + 1) * len(c["params"])].numpy(),
            want)


@pytest.mark.parametrize("kind", ["cs", "cms", "um"])
def test_peb_fleet_device_matches_reference(kind):
    rng = np.random.default_rng(5)
    ns = np.array([1, 2, 8, 4])
    widths = np.array([700, 70_000, 64, 3000])
    stacked = np.zeros((4, 8, 70_000), np.float32)
    for f, (n, w) in enumerate(zip(ns, widths)):
        stacked[f, :n, :w] = rng.integers(-3000, 3000, (n, w))
    want = REQ.peb_fleet(stacked, ns, widths, kind)
    got = TEQ.peb_fleet_device(torch.from_numpy(stacked), ns, widths, kind)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(TEQ.peb_fleet(stacked, ns, widths, kind),
                               want, rtol=0)
    for n, p in ((4, 100.0), (4, 1.0), (1024, 100.0), (1, 0.1)):
        assert TEQ.next_n(n, p, 10.0) == REQ.next_n(n, p, 10.0)


@pytest.mark.parametrize("kind,mitigate,per_epoch_sel", [
    ("cms", False, False), ("cs", False, False), ("cs", True, True),
    ("um", False, True)])
def test_query_engine_matches_reference_oracle(kind, mitigate, per_epoch_sel):
    """The port's gather/merge (torch) against the reference's float64
    host oracle on one random window stack: the selection is exact and
    only the f32 median midpoint rounds (the 1e-6 contract)."""
    rng = np.random.default_rng(9)
    e_count, n_rows, n_sub_max, width_max = 3, 6, 8, 70_000
    ns = np.array([1, 2, 8, 4, 2, 1])
    widths = np.array([700, 70_000, 64, 3000, 12, 5000])
    stack = np.zeros((e_count, n_rows, n_sub_max, width_max), np.float32)
    params = []
    for e in range(e_count):
        p = np.zeros((n_rows, TK.N_PARAMS), np.int32)
        p[:, :3] = rng.integers(0, 2 ** 31, (n_rows, 3))
        p[:, TK.PARAM_WIDTH] = widths
        p[:, TK.PARAM_N_SUB] = ns
        p[:, TK.PARAM_LOG2_N_SUB] = np.log2(ns)
        p[:, TK.PARAM_MIT] = [1, 0, 1, 1, 0, 1]
        params.append(p)
        for r in range(n_rows):
            stack[e, r, :ns[r], :widths[r]] = rng.integers(
                -50, 400, (ns[r], widths[r]))
    keys = rng.integers(0, 2 ** 32, 3000, dtype=np.uint64).astype(np.uint32)
    sel = np.array([1, 1, 0, 1, 1, 1], bool)
    if per_epoch_sel:
        sel = np.stack([sel, np.array([0, 1, 1, 0, 0, 1], bool),
                        np.ones(n_rows, bool)])
    want = RQ.fleet_query_window(list(stack), params, None, keys, kind,
                                 frag_sel=sel, single_hop=mitigate)
    got = TE.fleet_window_query_device(torch.from_numpy(stack), params, keys,
                                       kind, frag_sel=sel,
                                       single_hop=mitigate)
    assert got.shape == (len(keys),) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the same window as row groups, each cut to its own (n, width)
    groups = [(rows, torch.from_numpy(np.ascontiguousarray(
        stack[:, rows, :ns[rows].max(), :widths[rows].max()])))
        for rows in (np.array([2, 0, 5]), np.array([4, 1, 3]))]
    np.testing.assert_array_equal(
        TE.fleet_window_query_device(groups, params, keys, kind,
                                     frag_sel=sel, single_hop=mitigate), got)
    with pytest.raises(ValueError, match="exactly once"):
        TE.fleet_window_query_device(groups[:1], params, keys, kind)
    with pytest.raises(ValueError, match="no on-path"):
        TE.fleet_window_query_device(torch.from_numpy(stack), params, keys,
                                     kind, frag_sel=np.zeros(n_rows, bool))
