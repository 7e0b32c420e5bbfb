"""On-card tests of the port's CUDA kernels (B1 ragged fleet update, B2
single-fragment update, B3 dense fleet update) against their plain
PyTorch versions, and of the torch ops that run on the card (the UnivMon
query plane, the aggregated sketches) against the CPU, and of churn on the
card (dead rows exactly zero out of B1 and B3, parity recovery).  They
need an NVIDIA GPU and ``nvcc``; elsewhere they skip with the reason.  Run them on the card with ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``.

This file imports only the port (no JAX), so it also runs where JAX is
not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.sketch_update import fleet as FK

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or "
                    "interpret mode (their plain versions are tested on the "
                    "CPU in test_torch_{fleet,single,dense}_kernel.py)")
    return torch.device("cuda")


def random_csr(seed, n_prow, n_levels, n_sub_choices, widths, blk=256,
               log2_te=16, mean_pkts=3000):
    """A random ragged CSR case: skewed (Zipf) segment lengths with some
    empty rows, random seeds, per-row n_sub and width, random ts words
    (high bits included — the level / single-hop fields)."""
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.5, n_prow) * (mean_pkts // 4), 20 * mean_pkts)
    lens[rng.random(n_prow) < 0.2] = 0
    nblk = np.maximum(1, -(-lens // blk))
    nb = int(nblk.sum())
    keys = rng.integers(0, 2 ** 32, nb * blk, dtype=np.uint64).astype(np.uint32)
    ts = rng.integers(0, 2 ** 32, nb * blk, dtype=np.uint64).astype(np.uint32)
    vals = np.zeros(nb * blk, np.float32)
    starts = np.concatenate([[0], np.cumsum(nblk)]) * blk
    for r in range(n_prow):
        vals[starts[r]:starts[r] + lens[r]] = rng.integers(1, 4, lens[r])
    block_frag = np.repeat(np.arange(n_prow, dtype=np.int32), nblk)
    params = np.zeros((n_prow * n_levels, FK.N_PARAMS), np.int32)
    params[:, :3] = rng.integers(0, 2 ** 31, (n_prow * n_levels, 3))
    n_sub = np.repeat(rng.choice(n_sub_choices, n_prow), n_levels)
    params[:, FK.PARAM_WIDTH] = np.repeat(rng.choice(widths, n_prow), n_levels)
    params[:, FK.PARAM_N_SUB] = n_sub
    params[:, FK.PARAM_LOG2_N_SUB] = np.log2(n_sub).astype(np.int32)
    params[:, FK.PARAM_LEVEL] = np.tile(np.arange(n_levels), n_prow)
    params[:, FK.PARAM_MIT] = rng.random(n_prow * n_levels) < 0.5
    return dict(keys=keys, vals=vals, ts=ts, params=params,
                block_frag=block_frag, n_sub_max=int(n_sub.max()),
                width_max=int(params[:, FK.PARAM_WIDTH].max()), blk=blk,
                log2_te=log2_te)


CASES = {
    "cs-wide": dict(n_prow=12, n_levels=1, n_sub_choices=[1, 2, 4],
                    widths=[3728, 65536, 70001, 123974, 262144]),
    "cms-nsub64": dict(n_prow=16, n_levels=1, n_sub_choices=[1, 8, 64],
                       widths=[1000, 4096, 20000]),
    "um16-mit": dict(n_prow=6, n_levels=16, n_sub_choices=[1, 2, 16],
                     widths=[500, 7000, 70000]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_plain_version_on_card(cuda_device, name):
    case = random_csr(sum(map(ord, name)), **CASES[name])
    signed = not name.startswith("cms")
    kw = dict(n_sub_max=case["n_sub_max"], width_max=case["width_max"],
              log2_te=case["log2_te"], signed=signed, blk=case["blk"],
              n_levels=CASES[name]["n_levels"],
              with_mitigation=name.endswith("mit"))
    args = [case[k] for k in ("keys", "vals", "ts", "params", "block_frag")]
    before = FK.fleet_update_ragged.launches
    got = FK.fleet_update_ragged(*args, device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert FK.fleet_update_ragged.launches == before + 1
    ref = FK.fleet_update_ragged(*args, device="cpu", **kw)
    assert got.is_cuda and got.shape == ref.shape
    assert torch.equal(got.cpu(), ref)


SINGLE_CASES = {
    # width, n_sub, level, mitigation, signed, n_packets (not a blk multiple)
    "cs-n1-wide": (123974, 1, 0, False, True, 300_001),
    "cs-wrap-262144": (262144, 8, 0, False, True, 50_003),
    "cms-n256": (3728, 256, 0, False, False, 40_000),
    "um-level3": (7000, 4, 3, False, True, 20_011),
    "cs-mit": (26102, 16, 0, True, True, 30_007),
}


@pytest.mark.parametrize("name", sorted(SINGLE_CASES))
def test_single_kernel_equals_plain_version_on_card(cuda_device, name):
    from repro_torch.kernels.sketch_update import ops

    width, n_sub, level, mit, signed, n = SINGLE_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    keys = (rng.zipf(1.3, n) % 50_000).astype(np.uint32) \
        * np.uint32(2654435761)
    ts = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    vals = rng.integers(1, 4, n).astype(np.float32)
    kw = dict(width=width, n_sub=n_sub, log2_te=16, col_seed=11,
              sign_seed=22, sub_seed=33, level=level, mitigation=mit,
              signed=signed)
    before = ops.sketch_update.launches
    got = ops.sketch_update(keys, vals, ts, device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert ops.sketch_update.launches == before + 1
    plain = ops.sketch_update(keys, vals, ts, device=cuda_device,
                              backend="ref", **kw)
    assert ops.sketch_update.launches == before + 1
    assert got.is_cuda and got.shape == (n_sub, width)
    assert torch.equal(got, plain)
    assert torch.equal(got.cpu(), ops.sketch_update(keys, vals, ts,
                                                    device="cpu", **kw))


@pytest.mark.parametrize("signed", [True, False], ids=["cs", "cms"])
def test_dense_kernel_equals_plain_version_on_card(cuda_device, signed):
    rng = np.random.default_rng(5 + signed)
    n_frags, p_max = 9, 4096
    keys = rng.integers(0, 2 ** 32, (n_frags, p_max),
                        dtype=np.uint64).astype(np.uint32)
    ts = rng.integers(0, 2 ** 32, (n_frags, p_max),
                      dtype=np.uint64).astype(np.uint32)
    lens = rng.integers(0, p_max, n_frags)
    vals = (np.arange(p_max)[None, :] < lens[:, None]) \
        * rng.integers(1, 4, (n_frags, p_max)).astype(np.float32)
    params = np.zeros((n_frags, FK.N_PARAMS), np.int32)
    params[:, :3] = rng.integers(0, 2 ** 31, (n_frags, 3))
    n_sub = rng.choice([1, 2, 16, 64], n_frags)
    params[:, FK.PARAM_WIDTH] = rng.choice([300, 3728, 70001, 123974],
                                           n_frags)
    params[:, FK.PARAM_N_SUB] = n_sub
    params[:, FK.PARAM_LOG2_N_SUB] = np.log2(n_sub).astype(np.int32)
    kw = dict(n_sub_max=int(n_sub.max()),
              width_max=int(params[:, FK.PARAM_WIDTH].max()), log2_te=16,
              signed=signed)
    before = FK.fleet_update.launches
    got = FK.fleet_update(keys, vals, ts, params, device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert FK.fleet_update.launches == before + 1
    assert torch.equal(got.cpu(), FK.fleet_update(keys, vals, ts, params,
                                                  device="cpu", **kw))
    loop = FK.fleet_update_loop(keys, vals, ts, params, device=cuda_device,
                                **kw)
    assert torch.equal(loop, got)


def _stress_keys(case, rng):
    """A heavy hitter (one key on half of a 2^20-packet row) or a single
    row of ~10^6 Zipf(1.1) keys, the shapes B1 and B3 were redesigned
    for."""
    if case == "heavy-hitter":
        n = 1 << 20
        keys = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
        keys[rng.random(n) < 0.5] = np.uint32(0x9E3779B9)
        return keys
    return ((rng.zipf(1.1, 1_000_003) % 200_000).astype(np.uint32)
            * np.uint32(2654435761))


@pytest.mark.parametrize("case", ["heavy-hitter", "long-row"])
@pytest.mark.parametrize("layout", ["ragged", "dense"])
def test_fleet_kernels_on_stress_rows_on_card(cuda_device, layout, case):
    """One row that one key dominates (its counter an exact integer near
    10^6) or that holds ~10^6 packets: B1 and B3 equal their plain
    versions bit for bit, whatever order the atomics land in."""
    rng = np.random.default_rng(sum(map(ord, layout + case)))
    keys = _stress_keys(case, rng)
    n, blk = len(keys), 256
    p = -(-n // blk) * blk
    keys = np.pad(keys, (0, p - n))
    vals = np.pad(rng.integers(1, 4, n).astype(np.float32), (0, p - n))
    ts = rng.integers(0, 2 ** 32, p, dtype=np.uint64).astype(np.uint32)
    params = np.zeros((1, FK.N_PARAMS), np.int32)
    params[0, :3] = rng.integers(0, 2 ** 31, 3)
    params[0, FK.PARAM_WIDTH] = 123974
    params[0, FK.PARAM_N_SUB] = 2
    params[0, FK.PARAM_LOG2_N_SUB] = 1
    kw = dict(n_sub_max=2, width_max=123974, log2_te=16, signed=True)
    if layout == "ragged":
        fn = FK.fleet_update_ragged
        args = (keys, vals, ts, params, np.zeros(p // blk, np.int32))
        kw["blk"] = blk
    else:
        fn = FK.fleet_update
        args = (keys[None], vals[None], ts[None], params)
    before = fn.launches
    got = fn(*args, device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = fn(*args, device="cpu", **kw)
    assert float(want.abs().max()) > (1e5 if case == "heavy-hitter" else 1e4)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("layout", ["ragged", "dense"])
def test_fleet_kernels_on_fractional_values_on_card(cuda_device, layout):
    """Fractional values (multiples of 1/4, so every sum is exact in f32
    in any order) on counters that many lanes share: 2^16 packets on 16
    keys.  B1 and B3 equal their plain versions bit for bit, as for the
    integer packet counts of the main path."""
    rng = np.random.default_rng(1 if layout == "ragged" else 2)
    n = 1 << 16
    pool = rng.integers(0, 2 ** 32, 16, dtype=np.uint64).astype(np.uint32)
    keys = pool[rng.integers(0, 16, n)]
    vals = (rng.integers(1, 8, n) / 4).astype(np.float32)
    ts = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    params = np.zeros((1, FK.N_PARAMS), np.int32)
    params[0, :3] = rng.integers(0, 2 ** 31, 3)
    params[0, FK.PARAM_WIDTH] = 3728
    params[0, FK.PARAM_N_SUB] = 1
    kw = dict(n_sub_max=1, width_max=3728, log2_te=16, signed=True)
    if layout == "ragged":
        fn = FK.fleet_update_ragged
        args = (keys, vals, ts, params, np.zeros(n // 256, np.int32))
        kw["blk"] = 256
    else:
        fn = FK.fleet_update
        args = (keys[None], vals[None], ts[None], params)
    got = fn(*args, device=cuda_device, **kw)
    want = fn(*args, device="cpu", **kw)
    assert (want != torch.round(want)).any()     # fractional counters
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("case", ["heavy-hitter", "fractional", "level"])
def test_single_kernel_on_stress_rows_on_card(cuda_device, case):
    """B2 on a row that one key dominates (its counter an exact integer
    near 10^6), on fractional values (multiples of 1/4, exact in any
    order) that many lanes share, and on a UnivMon level row with §4.4
    mitigation over 2^20 packets: equal to its plain version bit for
    bit."""
    from repro_torch.kernels.sketch_update import ops

    rng = np.random.default_rng(sum(map(ord, case)))
    n = 1 << 20
    kw = dict(width=123974, n_sub=2, log2_te=16, col_seed=11, sign_seed=22,
              sub_seed=33, signed=True)
    vals = rng.integers(1, 4, n).astype(np.float32)
    if case == "heavy-hitter":
        keys = _stress_keys(case, rng)
    elif case == "fractional":
        n = 1 << 16
        pool = rng.integers(0, 2 ** 32, 16, dtype=np.uint64
                            ).astype(np.uint32)
        keys = pool[rng.integers(0, 16, n)]
        vals = (rng.integers(1, 8, n) / 4).astype(np.float32)
        kw.update(width=3728, n_sub=1)
    else:
        keys = rng.integers(0, 2 ** 32, n, dtype=np.uint64
                            ).astype(np.uint32)
        kw.update(width=7748, n_sub=4, level=3, mitigation=True)
    ts = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    before = ops.sketch_update.launches
    got = ops.sketch_update(keys, vals, ts, device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert ops.sketch_update.launches == before + 1
    plain = ops.sketch_update(keys, vals, ts, device=cuda_device,
                              backend="ref", **kw)
    if case == "heavy-hitter":
        assert float(plain.abs().max()) > 1e5
    if case == "fractional":
        assert (plain != torch.round(plain)).any()
    assert torch.equal(got, plain)


def test_univmon_query_plane_on_card(cuda_device):
    """The UnivMon all-levels window query and the G-sum (torch ops, no
    hand-written kernel) give on the card what they give on the CPU: the
    (L, K) estimates to f32 rounding of the median midpoint, and, on
    integer estimates with ties at the k_heavy cutoff and ``g(x) = x``,
    the same G-sum exactly (the stable sort keeps the lower index on the
    card too)."""
    from repro_torch.kernels.sketch_query import (um_gsum_device,
                                                  um_window_query_device)

    rng = np.random.default_rng(3)
    e_count, n_frags, n_levels = 2, 5, 4
    n_rows = n_frags * n_levels
    params = np.zeros((n_rows, FK.N_PARAMS), np.int32)
    params[:, :3] = rng.integers(0, 2 ** 31, (n_rows, 3))
    params[:, FK.PARAM_WIDTH] = np.repeat([300, 1000, 70001, 64, 5], n_levels)
    params[:, FK.PARAM_N_SUB] = np.repeat([1, 4, 1, 2, 1], n_levels)
    params[:, FK.PARAM_LEVEL] = np.tile(np.arange(n_levels), n_frags)
    stack = torch.from_numpy(rng.integers(-50, 50, (
        e_count, n_rows, 4, 70001)).astype(np.float32))
    keys = rng.integers(0, 2 ** 32, 5000, dtype=np.uint64).astype(np.uint32)
    sel = np.array([True, True, False, True, True])
    want = um_window_query_device(stack, [params] * e_count, keys, n_levels,
                                  frag_sel=sel)
    got = um_window_query_device(stack.to(cuda_device), [params] * e_count,
                                 keys, n_levels, frag_sel=sel)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    lvl = rng.integers(0, n_levels, 4096)
    ests = rng.choice([7.0, 7.0, 40.0, 300.0], (n_levels, 4096))
    assert um_gsum_device(ests, lvl, lambda x: x, k_heavy=100,
                          device=cuda_device) == \
        um_gsum_device(ests, lvl, lambda x: x, k_heavy=100, device="cpu")


# arming the guard sets torch's CUDA sync debug mode, which warns that it
# is a prototype
@pytest.mark.filterwarnings("ignore:Synchronization debug mode:UserWarning")
def test_univmon_grouped_gather_on_card(cuda_device, monkeypatch):
    """On a §6.1-sized UnivMon window (FatTree(4), 200 000 flows and 2 M
    packets over 32 epochs, its first window of 8, 16 levels, Gini-0.4
    memories) on the card: the grouped on-path gather over every path
    group, run under the armed transfer guard (nothing in it waits for
    the card), equals the one-group calls bit for bit, and a 5-, a 3- and
    a 1-hop group's estimates equal the host per-level oracle on the
    window's host copy within 1e-6."""
    from repro_torch import sanitize
    from repro_torch.core import query as Q
    from repro_torch.core.disketch import DiSketchSystem
    from repro_torch.net.simulator import Replayer
    from repro_torch.net.topology import FatTree
    from repro_torch.net.traffic import gen_workload, gini_memories

    topo = FatTree(4)
    wl = gen_workload(topo, n_flows=200_000, total_packets=2_000_000,
                      n_epochs=32, log2_te=16, burstiness=0.2, seed=1)
    rep = Replayer(wl, topo.n_switches)
    mems = gini_memories(topo.n_switches, 128 * 1024, 0.4,
                         np.random.RandomState(101))
    system = DiSketchSystem({sw: int(m) for sw, m in enumerate(mems)},
                            "um", rho_target=63.31, log2_te=16,
                            n_levels=16, device=cuda_device)
    epochs = list(range(8))
    system.run_window(0, [rep.epoch_stream(e) for e in epochs])
    fleet = system.fleet
    by_path = Q.path_groups(wl.paths)
    ks = np.concatenate([wl.keys[i] for i in by_path.values()])
    ends = np.cumsum([len(i) for i in by_path.values()])
    groups = [(p, np.arange(b - len(i), b))
              for (p, i), b in zip(by_path.items(), ends)]
    monkeypatch.setenv(sanitize._ENV, "1")
    got = fleet.um_level_window_query_groups(epochs, ks, groups)
    monkeypatch.setenv(sanitize._ENV, "0")
    assert got.is_cuda and got.shape == (16, len(wl.keys))
    got = got.cpu().numpy()
    one = np.concatenate([fleet.um_level_window_query(epochs, ks[i], path=p)
                          for p, i in groups], axis=1)
    np.testing.assert_array_equal(got, one)
    host = [fleet._window_bufs[0][0].host_epoch(e) for e in epochs]
    params = [fleet._params_log[e] for e in epochs]
    for hops in (5, 3, 1):
        path, idx = next((p, i) for p, i in groups if len(p) == hops)
        for level in range(16):
            want = Q.fleet_query_window(host, params, None, ks[idx], "um",
                                        frag_sel=fleet._row_sel(path, level))
            np.testing.assert_allclose(got[level, idx], want, rtol=1e-6,
                                       atol=1e-6)


def test_aggregated_sketches_on_card(cuda_device):
    """``core/sketches.py`` on the card: ``index_add_`` of int64 adds
    (exact, in any order) gives the CPU's counters bit for bit, and the
    float64 queries the same estimates."""
    from repro_torch.core import sketches as S

    rng = np.random.default_rng(4)
    keys = rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64).astype(
        np.uint32)[rng.zipf(1.2, 200_000) % 200_000]
    values = rng.integers(1, 4, len(keys))
    for kind in ("cs", "cms"):
        spec = S.SketchSpec(kind, 4, 70001, seed=7)
        got = S.update(spec, S.make_counters(spec, cuda_device), keys, values)
        want = S.update(spec, S.make_counters(spec, "cpu"), keys, values)
        assert got.is_cuda and torch.equal(got.cpu(), want)
        np.testing.assert_array_equal(S.query(spec, got, keys[:5000]),
                                      S.query(spec, want, keys[:5000]))
    spec = S.UnivMonSpec(4, 512, n_levels=16)
    got = S.um_update(spec, S.um_make_counters(spec, cuda_device), keys,
                      values)
    want = S.um_update(spec, S.um_make_counters(spec, "cpu"), keys, values)
    assert torch.equal(got.cpu(), want)


def _churn_streams(epoch, n_sw=6, log2_te=10, n_pkts=3000):
    from repro_torch.core.disketch import SwitchStream

    rng = np.random.default_rng(100 + epoch)
    out = {}
    for sw in range(n_sw):
        keys = rng.integers(0, 500, n_pkts).astype(np.uint32)
        ts = (epoch << log2_te) + np.sort(rng.integers(0, 1 << log2_te,
                                                       n_pkts))
        out[sw] = SwitchStream(keys, np.ones(n_pkts, np.int64), ts)
    return out


@pytest.mark.parametrize("layout", ["ragged", "dense"])
def test_dead_rows_exactly_zero_on_card(cuda_device, layout):
    """A dead switch's segment is value 0: B1 (ragged) and B3 (dense) leave
    its rows exactly zero on the card, launch as usual, and the live rows
    and records equal the plain versions' on the CPU."""
    from repro_torch.core.disketch import DiSketchSystem
    from repro_torch.net.simulator import FailureEvent

    mems = {sw: 1024 << (sw % 3) for sw in range(6)}
    systems = [DiSketchSystem(mems, "cs", rho_target=4.0, log2_te=10,
                              device=dev, fleet_kwargs={
                                  "layout": layout, "keep_stacked": True})
               for dev in (cuda_device, "cpu")]
    events = {1: [FailureEvent(1, 2, "fail"), FailureEvent(1, 4, "fail")],
              3: [FailureEvent(3, 4, "recover")]}
    launches = FK.fleet_update_ragged if layout == "ragged" \
        else FK.fleet_update
    before = launches.launches
    for e in range(4):
        for s in systems:
            s.run_epoch(e, _churn_streams(e), events=events.get(e))
    assert launches.launches > before
    card, cpu = systems
    assert card.n_log == cpu.n_log and card._dead_at == cpu._dead_at
    for e in range(4):
        assert sorted(card.records[e]) == sorted(cpu.records[e])
        for sw in cpu.records[e]:
            np.testing.assert_array_equal(card.records[e][sw].counters,
                                          cpu.records[e][sw].counters)
        buf = card.fleet._window_bufs[e][0]
        assert buf.resident
        for sw in card._dead_at.get(e, ()):
            g, j = buf._where[card.fleet._frag_pos[sw]]
            row = buf.device()[g][1][0, j]
            assert row.is_cuda and torch.equal(row, torch.zeros_like(row))
    keys = np.arange(500, dtype=np.uint32)
    for failures in ("oblivious", "mask"):
        np.testing.assert_allclose(
            card.query_flows(keys, [(1, 2, 4)] * 500, range(4),
                             merge="fragment", failures=failures),
            cpu.query_flows(keys, [(1, 2, 4)] * 500, range(4),
                            merge="fragment", failures=failures),
            rtol=1e-6, atol=1e-6)


def test_recover_round_trip_on_card(cuda_device):
    """A death at window offset 2 loses two epochs; the parity taken on
    the card before the loss rebuilds them bit for bit in the resident
    groups, and the recovered answers equal the CPU's."""
    from repro_torch.core.disketch import DiSketchSystem
    from repro_torch.net.simulator import FailureEvent

    mems = {sw: 256 << sw for sw in range(6)}
    kw = dict(rho_target=2.0, log2_te=10)
    lossy = DiSketchSystem(mems, "cms", device=cuda_device, fleet_kwargs={
        "parity_groups": [[0, 1, 2], [3, 4, 5]]}, **kw)
    cpu = DiSketchSystem(mems, "cms", device="cpu", fleet_kwargs={
        "parity_groups": [[0, 1, 2], [3, 4, 5]]}, **kw)
    for s in (lossy, cpu):
        s.run_window(0, [_churn_streams(e) for e in range(4)])
        s.run_window(4, [_churn_streams(e) for e in range(4, 8)],
                     events_by_epoch=[[], [], [FailureEvent(6, 3, "fail")],
                                      []])
    fleet = lossy.fleet
    buf = fleet._window_bufs[4][0]
    assert len(buf.device()) > 1                # members in several groups
    assert fleet.recoverable() == {4: [3], 5: [3]}
    assert all(p.is_cuda for e in range(4, 8) for p in fleet._parity[e])
    g, j = buf._where[3]
    assert not buf.device()[g][1][:2, j].any()          # epochs 4 and 5
    keys = np.arange(500, dtype=np.uint32)
    paths = [(2, 3)] * 500
    got = lossy.query_flows(keys, paths, range(4, 8), merge="fragment",
                            failures="recover")
    assert buf.resident and fleet.recoverable() == {}
    np.testing.assert_allclose(
        got, cpu.query_flows(keys, paths, range(4, 8), merge="fragment",
                             failures="recover"), rtol=1e-6, atol=1e-6)
    for e in range(4, 8):
        for sw in mems:
            np.testing.assert_array_equal(lossy.records[e][sw].counters,
                                          cpu.records[e][sw].counters)
    assert lossy.records[4][3].counters.any()


def test_lossy_control_plane_on_card(cuda_device):
    """The versioned control plane over lossy channels drives the window
    path on the card exactly as on the CPU: the same applied and intended
    configs, stale epochs and protocol counters, and every resident row
    group of every window equal, launched through B1."""
    from repro_torch.core.disketch import DiSketchSystem
    from repro_torch.net.channel import LossyChannel
    from repro_torch.runtime import VersionedControlPlane

    mems = {sw: 256 << (sw % 4) for sw in range(6)}
    planes = []
    before = FK.fleet_update_ragged.launches
    for dev in (cuda_device, "cpu"):
        plane = VersionedControlPlane(
            DiSketchSystem(mems, "cms", rho_target=0.5, log2_te=10,
                           device=dev),
            LossyChannel(p_drop=0.4, p_dup=0.2, p_reorder=0.3, delay=(0, 1),
                         seed=17),
            LossyChannel(p_drop=0.2, p_dup=0.2, delay=(0, 1), seed=18))
        for e0 in range(0, 8, 2):
            plane.run_window(e0, [_churn_streams(e) for e in (e0, e0 + 1)])
        planes.append(plane)
    assert FK.fleet_update_ragged.launches > before
    card, cpu = planes
    assert card.stale_epochs() and card.stale_epochs() == cpu.stale_epochs()
    assert card.applied_log == cpu.applied_log
    assert card.intent_log == cpu.intent_log
    assert card.stats() == cpu.stats()
    assert card.system.n_log == cpu.system.n_log
    for e0 in range(0, 8, 2):
        got = card.fleet._window_bufs[e0][0].device()
        want = cpu.fleet._window_bufs[e0][0].device()
        assert len(got) == len(want)
        for (rows, c), (rows_w, c_w) in zip(got, want):
            assert c.is_cuda and np.array_equal(rows, rows_w)
            assert torch.equal(c.cpu(), c_w)


def test_export_plane_on_card(cuda_device, tmp_path):
    """The durable export plane holds cells back and delivers them in the
    resident groups on the card exactly as on the CPU: the same protocol
    through a crash and a drain, the windows never copied to the host,
    and the drained groups equal a plane-free run's."""
    from repro_torch.core.disketch import DiSketchSystem
    from repro_torch.net.channel import LossyChannel
    from repro_torch.runtime import DurableExportPlane

    mems = {sw: 256 << (sw % 4) for sw in range(6)}

    def window_run(target):
        for e0 in range(0, 8, 4):
            target.run_window(e0, [_churn_streams(e)
                                   for e in range(e0, e0 + 4)])
            if e0 == 0 and isinstance(target, DurableExportPlane):
                for _ in range(3):
                    target.step()
                target.checkpoint()
                target.step()
                target.crash()

    planes = []
    for dev in (cuda_device, "cpu"):
        plane = DurableExportPlane(
            DiSketchSystem(mems, "cs", rho_target=0.5, log2_te=10,
                           device=dev),
            LossyChannel(p_drop=0.3, p_dup=0.2, p_reorder=0.3, delay=(0, 2),
                         seed=9),
            LossyChannel(p_drop=0.15, p_dup=0.2, delay=(0, 1), seed=10),
            max_retries=12, ckpt_dir=str(tmp_path / str(dev)))
        window_run(plane)
        plane.drain()
        planes.append(plane)
    card, cpu = planes
    free = DiSketchSystem(mems, "cs", rho_target=0.5, log2_te=10,
                          device=cuda_device)
    window_run(free)
    assert card.stats() == cpu.stats() and card.stats()["n_crashes"] == 1
    assert card.lost_cells() == set() and not card.fleet._unexported
    for e0 in range(0, 8, 4):
        buf = card.fleet._window_bufs[e0][0]
        assert buf.resident and buf._host is None
        for (rows, c), (_, c_cpu), (_, c_free) in zip(
                buf.device(), cpu.fleet._window_bufs[e0][0].device(),
                free.fleet._window_bufs[e0][0].device(), strict=True):
            assert c.is_cuda and torch.equal(c, c_free)
            assert torch.equal(c.cpu(), c_cpu)


def test_chaos_harness_on_card(cuda_device):
    """The chaos harness (control over export over the fleet window, churn
    inside a window with resource pressure, lossy channels, collector
    crashes) runs on the card exactly as on the CPU: the same report and
    crash log, and every applied cell equal; the twin holds on both."""
    from repro_torch.core.disketch import DiSketchSystem
    from repro_torch.net.channel import LossyChannel
    from repro_torch.net.simulator import (ComposedSchedule, FailureSchedule,
                                           ResourcePressure)
    from repro_torch.runtime import (ChaosHarness, DurableExportPlane,
                                     VersionedControlPlane)

    mems = {sw: 256 << (sw % 4) for sw in range(6)}

    def build(dev):
        return DiSketchSystem(mems, "cms", rho_target=0.5, log2_te=10,
                              device=dev)

    harnesses = []
    before = FK.fleet_update_ragged.launches
    for dev in (cuda_device, "cpu"):
        schedule = ComposedSchedule([
            FailureSchedule(6, downs={2: (3, 6)}),
            ResourcePressure(6, horizon=8, seed=5, p_grab=0.3)])
        h = ChaosHarness(VersionedControlPlane(
            DurableExportPlane(
                build(dev),
                LossyChannel(p_drop=0.3, p_dup=0.2, p_reorder=0.3,
                             delay=(0, 2), seed=9),
                LossyChannel(p_drop=0.15, p_dup=0.2, delay=(0, 1), seed=10),
                max_retries=12, steps_per_dispatch=0),
            LossyChannel(p_drop=0.4, p_dup=0.2, p_reorder=0.3, delay=(0, 1),
                         seed=17),
            LossyChannel(p_drop=0.2, p_dup=0.2, delay=(0, 1), seed=18)),
            steps_per_dispatch=6, crash_every=2)
        for e0 in range(0, 8, 2):
            es = (e0, e0 + 1)
            h.run_window(e0, [_churn_streams(e) for e in es],
                         events_by_epoch=[schedule.advance(e) for e in es])
        harnesses.append((h, h.finish()))
        assert h.verify_config_twin(lambda: build(dev)) > 0
    assert FK.fleet_update_ragged.launches > before
    (card, report), (cpu, cpu_report) = harnesses
    assert report == cpu_report and report["crashes"] == 2
    assert card.crash_log == cpu.crash_log
    assert card.system.fleet._lost and card.system.fleet.device.type == "cuda"
    applied = sorted(card.export.collector.applied)
    assert applied == sorted(cpu.export.collector.applied)
    for sw, e in applied:
        np.testing.assert_array_equal(card.fleet.cell_counters(e, sw),
                                      cpu.fleet.cell_counters(e, sw))


@pytest.mark.parametrize("spread", ["one card", "across cards"])
def test_sharded_window_on_card(cuda_device, spread):
    """Four shards (``make_switch_mesh(4, devices=[cuda] * 4)`` on one
    card, or one shard a card on up to four cards) equal the
    single-device window run cell by cell and query by query, with parity
    and a death inside a window; every group stays on its shard's card
    and B1 launches once per distinct n_sub of each shard."""
    from types import SimpleNamespace

    from repro_torch.core.disketch import DiSketchSystem
    from repro_torch.core.fleet import parity_groups_chunked
    from repro_torch.launch import make_switch_mesh

    mems = {sw: 256 << (sw % 4) for sw in range(6)}
    if spread == "one card":
        mesh = make_switch_mesh(4, devices=[cuda_device] * 4)
    elif torch.cuda.device_count() < 2:
        pytest.skip("needs two or more GPUs: one shard a card")
    else:
        mesh = make_switch_mesh(min(torch.cuda.device_count(), 4))
    # parity groups of one shard's size: shard-local for 2, 3 or 4 shards
    groups = parity_groups_chunked(range(6), -(-6 // len(mesh.devices)))
    systems, launches = [], []
    for where in (dict(device=cuda_device), dict(mesh=mesh)):
        s = DiSketchSystem(mems, "cs", rho_target=0.5, log2_te=10,
                           fleet_kwargs={"parity_groups": groups}, **where)
        before = FK.fleet_update_ragged.launches
        for e0 in range(0, 8, 4):
            ev = [[], [SimpleNamespace(kind="fail", switch=2, factor=1.0)],
                  [], []] if e0 == 0 else None
            s.run_window(e0, [_churn_streams(e) for e in range(e0, e0 + 4)],
                         events_by_epoch=ev)
        launches.append(FK.fleet_update_ragged.launches - before)
        systems.append(s)
    one, four = systems
    fleet = four.fleet
    expected = sum(len(np.unique(fleet._params_log[e0][lo:hi,
                                                       FK.PARAM_N_SUB]))
                   for e0 in (0, 4) for lo, hi in fleet._shard_frag_bounds
                   if lo < hi)
    assert launches[1] == expected >= launches[0] > 0
    for buf, _ in fleet._window_bufs.values():
        for rows, c in buf.device():
            shard = [s for s, (lo, hi) in enumerate(fleet._shard_frag_bounds)
                     if lo <= rows[0] < hi][0]
            assert c.device == mesh.devices[shard] and c.is_cuda
    assert one.fleet.recoverable() == fleet.recoverable() == {0: [2]}
    keys = np.arange(0, 4000, 13, dtype=np.uint32)
    paths = [(0, 2, 4)] * len(keys)
    for failures in ("oblivious", "mask", "recover"):
        assert np.array_equal(
            one.query_flows(keys, paths, range(8), merge="fragment",
                            failures=failures),
            four.query_flows(keys, paths, range(8), merge="fragment",
                             failures=failures))
    for e in range(8):
        for sw in mems:
            assert np.array_equal(one.fleet.cell_counters(e, sw),
                                  fleet.cell_counters(e, sw))


# -- B1's stream built on the card (csr_streams, the CSR scatter) ----------

STAGED = [("cs", 1, False, ()), ("cms", 1, False, ()), ("um", 4, False, ()),
          ("cs", 1, True, ()), ("um", 4, True, ()), ("cs", 1, False, (0, 3)),
          ("um", 4, True, (2,)), ("um", 16, False, ()),
          ("um", 16, False, (1, 2))]


def _staged_window(kind, n_levels, mitigation, masked, epochs, log2_te=12,
                   fold=True):
    """Folded (or, without ``fold``, unfolded), masked ``FleetPacket``s of a
    small fleet: skewed segments, an empty switch (3) and one with no
    stream (11); ``(packets, groups)`` with ``groups`` each n_sub group's
    fragment positions."""
    from repro_torch.core import fleet as F
    from repro_torch.core.disketch import SwitchStream

    lens = {0: 3000, 3: 0, 5: 500, 9: 9000}
    ns = {0: 1, 3: 2, 5: 8, 9: 2, 11: 4}
    order = tuple(sorted(ns))
    packets = []
    for e in epochs:
        rng = np.random.default_rng(e)
        streams = {}
        for sw, n in lens.items():
            keys = (rng.zipf(1.3, n) % 2000).astype(np.uint32) \
                * np.uint32(2654435761)
            streams[sw] = SwitchStream(
                keys, rng.integers(1, 4, n).astype(np.int64),
                rng.integers(0, 1 << log2_te, n) + (e << log2_te),
                rng.random(n) < 0.3)
        packet = F.mask_fragment_values(F.pack_streams(streams, order),
                                        masked)
        packets.append(F.fold_packet_flags(
            packet, log2_te, n_levels=n_levels, level_seed=7777,
            mitigation=mitigation) if fold else packet)
    nsub = np.array([ns[sw] for sw in order])
    return packets, [np.flatnonzero(nsub == n) for n in np.unique(nsub)]


@pytest.mark.parametrize("blk", [8, 256])
@pytest.mark.parametrize("case", STAGED, ids=[
    f"{k}{n}{'-mit' if m else ''}{'-masked' if d else ''}"
    for k, n, m, d in STAGED])
def test_csr_scatter_equals_pack_csr_on_card(cuda_device, case, blk):
    """Each row group's stream that the CSR scatter lays out on the card
    holds ``pack_csr``'s bits, padding and bucket blocks included, for two
    windows staged back to back with no sync between them (the second
    may reuse the first's page-locked buffers); one launch a group, each
    a ``launches`` count of its ``fleet.pack_csr`` span.  Then the same
    windows staged unfolded, as ``FleetEpochRunner._dispatch`` stages them
    on every device: the scatter folds each key's UnivMon level (16 levels and
    level seed 7777 as at §6.1, and 4), its streams the bits of the host's
    ``fold_packet_flags`` + ``pack_csr``, and each span's ``folded`` count
    its group's packets (0 without levels); under §4.4 mitigation the host
    folds the whole word and the scatter gets one level."""
    from repro_torch import obs
    from repro_torch.core import fleet as F

    kind, n_levels, mitigation, _ = case
    windows = [_staged_window(*case, epochs) for epochs in ((5, 6, 7),
                                                           (8, 9))]
    obs.clear()
    before = FK.csr_scatter.launches
    got = [F.csr_streams(packets, [(cuda_device, idx) for idx in idxs], blk)
           for packets, idxs in windows]
    assert FK.csr_scatter.launches - before == 8
    assert sum((s.counts or {}).get("launches", 0) for s in obs.spans()
               if s.name == "fleet.pack_csr") == 8
    _assert_streams_are_pack_csrs(windows, got, blk)
    fold = dict(log2_te=12, level_seed=7777,
                n_levels=1 if mitigation else n_levels)
    raw = windows if mitigation else [
        _staged_window(*case, epochs, fold=False)
        for epochs in ((5, 6, 7), (8, 9))]
    obs.clear()
    got = [F.csr_streams(packets, [(cuda_device, idx) for idx in idxs], blk,
                         **fold) for packets, idxs in raw]
    folded = [s.counts["folded"] for s in obs.spans()
              if s.name == "fleet.pack_csr"
              and "launches" in (s.counts or {})]
    assert len(folded) == 8
    n_live = sum(len(p.keys) for packets, _ in raw for p in packets)
    assert sum(folded) == (n_live if fold["n_levels"] > 1 else 0)
    _assert_streams_are_pack_csrs(windows, got, blk)


def _assert_streams_are_pack_csrs(windows, got, blk):
    """Each group's card stream holds the bits of ``pack_csr`` of the
    group's folded packets."""
    from repro_torch.core import fleet as F

    for (packets, idxs), streams in zip(windows, got):
        for idx, (keys, vals, ts, bf) in zip(idxs, streams):
            want = F.pack_csr([p.select(idx) for p in packets], blk)
            np.testing.assert_array_equal(bf, want[3])
            for t, w in zip((keys, vals, ts), want[:3]):
                assert t.is_cuda
                np.testing.assert_array_equal(
                    t.cpu().numpy().view(np.uint32), w.view(np.uint32))


def _s61_window_run(kind, dev, wl, n_windows=2):
    """Two windows of 8 back to back (no sync between them) at the §6.1
    memories (FatTree(4), 128 KB a switch, Gini 0.4)."""
    from repro_torch.core.disketch import DiSketchSystem
    from repro_torch.net.simulator import Replayer
    from repro_torch.net.traffic import gini_memories

    rep = Replayer(wl, 20)
    mems = {sw: int(m) for sw, m in enumerate(gini_memories(
        20, 128 * 1024, 0.4, np.random.RandomState(101)))}
    system = DiSketchSystem(mems, kind, rho_target={"cs": 15.67,
                                                    "um": 63.31}[kind],
                            log2_te=16, n_levels=16, device=dev)
    for e0 in range(0, 8 * n_windows, 8):
        system.run_window(e0, [rep.epoch_stream(e)
                               for e in range(e0, e0 + 8)])
    return system


@pytest.mark.parametrize("kind", ["cs", "um"])
def test_run_window_on_card_equals_cpu(cuda_device, kind, monkeypatch):
    """``run_window`` on the card, whose B1 streams the CSR scatter builds
    there, gives the counters of every cell and the Eq. 6 trajectory of
    the CPU path (the scatter's plain version) bit for bit, and its PEBs bit
    for bit those of a card run fed ``pack_csr``'s streams (the same
    float64 reductions on the same counters; the CPU's sum in another
    order, so there they agree to 1e-10): the §6.1 cs trace (2 M packets,
    32 epochs), and for UnivMon (16 levels) a lighter trace at the same
    memories; two windows each."""
    from repro_torch.core import fleet as F
    from repro_torch.net.topology import FatTree
    from repro_torch.net.traffic import gen_workload

    size = (dict(n_flows=200_000, total_packets=2_000_000, n_epochs=32)
            if kind == "cs" else
            dict(n_flows=20_000, total_packets=200_000, n_epochs=16))
    wl = gen_workload(FatTree(4), log2_te=16, burstiness=0.2, seed=1, **size)
    before = FK.csr_scatter.launches
    card = _s61_window_run(kind, cuda_device, wl)
    assert FK.csr_scatter.launches - before >= 2
    cpu = _s61_window_run(kind, "cpu", wl)
    with monkeypatch.context() as m:
        m.setattr(F, "csr_streams", lambda packets, groups, blk, **fold: [
            F.pack_csr([F.fold_packet_flags(p, **fold).select(idx)
                        for p in packets], blk)
            for _, idx in groups])
        before = FK.csr_scatter.launches
        host_packed = _s61_window_run(kind, cuda_device, wl)
        assert FK.csr_scatter.launches == before
    assert card.n_log == cpu.n_log == host_packed.n_log
    assert card.peb_log == host_packed.peb_log
    for got, want in zip(card.peb_log, cpu.peb_log):
        assert got.keys() == want.keys()
        np.testing.assert_allclose([got[sw] for sw in got],
                                   [want[sw] for sw in got], rtol=1e-10)
    for e in range(16):
        for sw in range(20):
            assert np.array_equal(card.fleet.cell_counters(e, sw),
                                  cpu.fleet.cell_counters(e, sw)), (e, sw)
