"""The port's dense-rectangle fleet update (``fleet_update``, kernel B3's
wrapper), its loop-of-kernels baseline (``fleet_update_loop``, kernel B2
per row) and ``FleetPacket.densify`` on the CPU against the JAX package.

On CPU tensors the wrappers run their plain PyTorch versions.  Counters
must equal the reference's jnp scatter oracle
``fleet_update_loop(backend="ref")`` (no Pallas) bit for bit
(``array_equal``), and the dense path must equal the ragged one on the
same epoch.  The CUDA kernels are held to the same plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro.core import fleet as RF
from repro.core.disketch import SwitchStream
from repro.core.fragment import FragmentConfig as RCfg
from repro.kernels.sketch_update import fleet as RK
from repro_torch.core import fleet as TF
from repro_torch.core.fragment import FragmentConfig as TCfg
from repro_torch.kernels.sketch_update import fleet as TK

LOG2_TE = 12
EPOCH = 5


def _epoch(kind, ns, n_levels=1, mitigation=False, seed=0):
    """Heterogeneous widths (one above 65536), skewed segments and an
    empty one; the reference's and the port's packed epoch and tables."""
    L = n_levels if kind == "um" else 1
    mems = {0: 4 * 1000 * L, 1: 4 * 70_000 * L, 2: 4 * 300 * L,
            3: 4 * 5000 * L, 4: 4 * 2000 * L}
    lens = {0: 3000, 1: 1200, 2: 500, 3: 0, 4: 2600}
    rng = np.random.default_rng(seed)
    streams = {}
    for sw, n in lens.items():
        keys = (rng.zipf(1.3, n) % 2000).astype(np.uint32) \
            * np.uint32(2654435761)
        streams[sw] = SwitchStream(
            keys, rng.integers(1, 4, n).astype(np.int64),
            rng.integers(0, 1 << LOG2_TE, n) + (EPOCH << LOG2_TE),
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
    params = TF.build_params(tfr, EPOCH, ns, order)
    np.testing.assert_array_equal(params,
                                  RF.build_params(rfr, EPOCH, ns, order))
    return dict(rp=rp, tp=tp, params=params, L=L, tfr=tfr,
                n_sub_max=max(ns.values()),
                width_max=max(c.width for c in tfr.values()),
                signed=kind != "cms")


DENSE_CASES = {
    "cs": ("cs", {0: 1, 1: 2, 2: 8, 3: 2, 4: 4}),
    "cms": ("cms", {0: 8, 1: 1, 2: 2, 3: 1, 4: 16}),
    "cs-n64": ("cs", {0: 64, 1: 1, 2: 1, 3: 1, 4: 2}),
}


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_dense_update_matches_reference_oracle(name):
    kind, ns = DENSE_CASES[name]
    c = _epoch(kind, ns)
    keys, vals, ts = c["tp"].densify(256)
    for got, want in zip((keys, vals, ts), c["rp"].densify(256)):
        np.testing.assert_array_equal(got, want)
    kw = dict(n_sub_max=c["n_sub_max"], width_max=c["width_max"],
              log2_te=LOG2_TE, signed=c["signed"])
    want = RK.fleet_update_loop(keys, vals, ts, c["params"], backend="ref",
                                **kw)
    got = TK.fleet_update(keys, vals, ts, c["params"], device="cpu", **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # a rectangle that is not a blk multiple is padded, not refused
    cut = keys.shape[1] - 100
    np.testing.assert_array_equal(
        TK.fleet_update(keys[:, :cut], vals[:, :cut], ts[:, :cut],
                        c["params"], device="cpu", **kw).numpy(),
        RK.fleet_update_loop(keys[:, :cut], vals[:, :cut], ts[:, :cut],
                             c["params"], backend="ref", **kw))
    # the dense rectangle equals the ragged CSR stream on the same epoch
    csr = TF.pack_csr([c["tp"]], 256)
    ragged = TK.fleet_update_ragged(*csr[:3], c["params"], csr[3],
                                    device="cpu", blk=256, **kw)
    assert torch.equal(ragged, got)
    for backend in ("cuda", "ref"):
        loop = TK.fleet_update_loop(keys, vals, ts, c["params"],
                                    backend=backend, device="cpu", **kw)
        assert torch.equal(loop, got)


LOOP_CASES = {
    "um4": ("um", {0: 1, 1: 2, 2: 8, 3: 2, 4: 1}, 4, False),
    "um4-mit": ("um", {0: 2, 1: 2, 2: 1, 3: 8, 4: 4}, 4, True),
    "cs-mit": ("cs", {0: 2, 1: 1, 2: 8, 3: 2, 4: 2}, 1, True),
}


@pytest.mark.parametrize("name", sorted(LOOP_CASES))
def test_loop_baseline_covers_level_and_mitigation_rows(name):
    """The loop re-dispatches each packet row at every level row's own
    level / §4.4 parameters, as the reference's loop does."""
    kind, ns, n_levels, mit = LOOP_CASES[name]
    c = _epoch(kind, ns, n_levels, mit, seed=3)
    keys, vals, ts = c["tp"].densify(256)
    kw = dict(n_sub_max=c["n_sub_max"], width_max=c["width_max"],
              log2_te=LOG2_TE, signed=c["signed"])
    want = RK.fleet_update_loop(keys, vals, ts, c["params"], backend="ref",
                                **kw)
    got = TK.fleet_update_loop(keys, vals, ts, c["params"], device="cpu",
                               **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    csr = TF.pack_csr([c["tp"]], 256)
    ragged = TK.fleet_update_ragged(*csr[:3], c["params"], csr[3],
                                    device="cpu", n_levels=c["L"],
                                    with_mitigation=mit, **kw)
    assert torch.equal(ragged, got)


@pytest.mark.parametrize("n_frags,p_max", [
    (0, 256), (1, 0), (1, 4), (1, 256), (1, 1024), (3, 1028), (20, 32768),
    (2, 1_000_192)])
def test_dense_geometry_covers_every_chunk_once(n_frags, p_max):
    """Kernel B3's CTAs cover every slot of every row exactly once, in
    chunks of at most CTA_SLOTS (one 16-byte load per thread)."""
    per_row, grid = TK.dense_geometry(n_frags, p_max)
    assert 0 <= grid <= 2 ** 31 - 1 and grid == n_frags * per_row
    seen = np.zeros((n_frags, p_max), np.int64)
    for c in range(grid):
        f, j = divmod(c, per_row)
        lo, hi = j * TK.CTA_SLOTS, min((j + 1) * TK.CTA_SLOTS, p_max)
        assert lo < hi                          # no idle CTA
        seen[f, lo:hi] += 1
    assert (seen == 1).all()


def test_dense_geometry_refusals():
    with pytest.raises(ValueError, match="multiple of 4"):
        TK.dense_geometry(2, 1026)
    with pytest.raises(ValueError, match="grid limit"):
        TK.dense_geometry(2 ** 21, 2 ** 20 * TK.CTA_SLOTS)


@pytest.mark.parametrize("name", ["cs", "cms"])
def test_dense_chunk_shares_sum_to_reference_oracle(name):
    """The plain version over each CTA's chunk of the rectangle, as
    ``dense_geometry`` cuts it, sums to the reference's counters."""
    kind, ns = DENSE_CASES[name]
    c = _epoch(kind, ns, seed=2)
    keys, vals, ts = c["tp"].densify(256)
    kw = dict(n_sub_max=c["n_sub_max"], width_max=c["width_max"],
              log2_te=LOG2_TE, signed=c["signed"])
    per_row, grid = TK.dense_geometry(*keys.shape)
    assert per_row > 1
    rows = [torch.from_numpy(x.view(np.int32).copy()) if x.dtype == np.uint32
            else torch.from_numpy(x) for x in (keys, vals, ts)]
    total = torch.zeros(len(c["params"]), c["n_sub_max"], c["width_max"])
    for cta in range(grid):
        f, j = divmod(cta, per_row)
        part = [torch.zeros_like(x) for x in rows]
        cut = slice(j * TK.CTA_SLOTS, (j + 1) * TK.CTA_SLOTS)
        for p, x in zip(part, rows):
            p[f, cut] = x[f, cut]
        total += TK.fleet_update_ref(*part, torch.from_numpy(c["params"]),
                                     **kw)
    want = RK.fleet_update_loop(keys, vals, ts, c["params"], backend="ref",
                                **kw)
    assert np.abs(want).sum() > 0
    np.testing.assert_array_equal(total.numpy(), want)


def test_dense_argument_checks():
    c = _epoch("cs", {0: 1, 1: 2, 2: 8, 3: 2, 4: 4})
    keys, vals, ts = c["tp"].densify(256)
    kw = dict(n_sub_max=c["n_sub_max"], width_max=c["width_max"],
              log2_te=LOG2_TE, device="cpu")
    with pytest.raises(ValueError, match="n_sub"):
        TK.fleet_update(keys, vals, ts, c["params"], **dict(kw, n_sub_max=4))
    with pytest.raises(ValueError, match="width"):
        TK.fleet_update(keys, vals, ts, c["params"],
                        **dict(kw, width_max=1000))
    with pytest.raises(ValueError, match="packet rows"):
        TK.fleet_update(keys[:3], vals[:3], ts[:3], c["params"], **kw)
    with pytest.raises(ValueError, match="2-d"):
        TK.fleet_update(keys[0], vals[0], ts[0], c["params"], **kw)
    with pytest.raises(ValueError, match="multiple"):
        TK.fleet_update_loop(keys[:3], vals[:3], ts[:3], c["params"], **kw)
    with pytest.raises(ValueError, match="backend"):
        TK.fleet_update_loop(keys, vals, ts, c["params"], backend="pallas",
                             **kw)


def test_dense_runner_refusals():
    """The reference's refusals: dense is a cs/cms oracle without
    mitigation, and per-epoch only."""
    for kw in (dict(kind="um", n_levels=4), dict(kind="cs",
                                                 mitigation=True)):
        kind = kw.pop("kind")
        frags = {0: TCfg(0, kind, 4096, **kw)}
        with pytest.raises(ValueError, match="dense"):
            TF.FleetEpochRunner(frags, LOG2_TE, layout="dense",
                                device="cpu")
        rfrags = {0: RCfg(0, kind, 4096, **kw)}
        with pytest.raises(ValueError, match="dense"):
            RF.FleetEpochRunner(rfrags, LOG2_TE, layout="dense")
    with pytest.raises(ValueError, match="layout"):
        TF.FleetEpochRunner({0: TCfg(0, "cs", 4096)}, LOG2_TE,
                            layout="csr", device="cpu")
    c = _epoch("cs", {sw: 1 for sw in range(5)})
    runner = TF.FleetEpochRunner(c["tfr"], LOG2_TE, layout="dense",
                                 device="cpu")
    with pytest.raises(ValueError, match="per-epoch only"):
        runner.run_window(EPOCH, {sw: 1 for sw in range(5)},
                          [c["tp"], c["tp"]])


def test_library_digest_covers_included_headers(tmp_path, monkeypatch):
    """A library is named by a digest of its sources and every header they
    include, so editing a shared header rebuilds every library that uses
    it instead of loading a stale one."""
    from repro_torch.kernels import build

    for name, srcs in build.SOURCES.items():
        files = [p.name for src in srcs
                 for p in build._sources(build._PKG / src)]
        assert files == [f for src in srcs
                         for f in (src.rsplit("/", 1)[1], "sketch_hash.cuh")
                         ], name
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "a.cu").write_text('#include "h.cuh"\nint a;\n')
    (tmp_path / "csrc" / "h.cuh").write_text('#include "g.cuh"\n')
    (tmp_path / "csrc" / "g.cuh").write_text("int g;\n")
    monkeypatch.setattr(build, "_PKG", tmp_path)
    monkeypatch.setattr(build, "SOURCES", {"a": ("csrc/a.cu",)})
    before = build.library_path("a")
    (tmp_path / "csrc" / "g.cuh").write_text("int g = 1;\n")
    after = build.library_path("a")
    assert before != after and after.name.startswith("a-")
