"""Hypothesis property tests of the port: every property of
``tests/test_properties.py`` carried over to ``src/repro_torch/``, at the
reference's ``max_examples`` (hypothesis's default of 100 where it sets
none) with ``deadline=None``.  Each property is also held to the
reference's function on the same drawn inputs.

``test_sharded_merge_matches_host_oracle`` is held to the reference's
numpy ``fleet_query_epoch``: the reference's own sharded merge fails under
jax 0.9.  The port's mesh is one process, so a shard is a row group on its
own device (here all on the CPU) and the property draws any assignment of
rows to groups.

``test_bf16_value_modes_bit_identical`` and
``test_select_geometry_respects_budget`` test the TPU kernel's value modes
and VMEM geometry, which the port does not have; they get no counterpart.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import equalize as REQ
from repro.core import fragment as RFR
from repro.core import hashing as RH
from repro.core import query as RQ
from repro.core import sketches as RS
from repro.core.disketch import DiSketchSystem as RSystem
from repro.core.disketch import SwitchStream as RStream
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.net.channel import LossyChannel as RChannel
from repro.net.simulator import FailureEvent as RFailureEvent
from repro.runtime.export import AckMsg as RAckMsg
from repro.runtime.export import DurableExportPlane as RPlane
from repro_torch.core import equalize as EQ
from repro_torch.core import hashing as H
from repro_torch.core import query as Q
from repro_torch.core import sketches as S
from repro_torch.core.disketch import DiSketchSystem, SwitchStream
from repro_torch.core.fragment import (FragmentConfig, packet_subepoch,
                                       process_epoch)
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels.sketch_query import fleet_window_query_device
from repro_torch.kernels.sketch_update import fleet as FK
from repro_torch.net.channel import LossyChannel
from repro_torch.net.simulator import FailureEvent
from repro_torch.runtime.export import AckMsg, DurableExportPlane

LOG2_TE = 10


@settings(deadline=None, max_examples=100)
@given(st.integers(0, 2**32 - 1), st.integers(0, 2**31 - 1),
       st.sampled_from([1, 2, 4, 8, 16, 64]))
def test_hash_pow2_in_range(key, seed, n):
    keys = np.array([key], np.uint32)
    h = int(H.hash_pow2(keys, seed, n)[0])
    assert 0 <= h < n
    assert h == int(RH.hash_pow2(keys, seed, n)[0])
    assert h == int(H.hash_pow2_torch(torch.tensor([key]), seed, n)[0])


@settings(deadline=None, max_examples=100)
@given(st.integers(0, 2**31 - 1), st.integers(2, 100000))
def test_hash_mod_in_range(seed, mod):
    keys = np.arange(64, dtype=np.uint32) * np.uint32(2654435769)
    h = H.hash_mod(keys, seed, mod)
    assert (h >= 0).all() and (h < mod).all()
    np.testing.assert_array_equal(h, RH.hash_mod(keys, seed, mod))
    np.testing.assert_array_equal(
        H.hash_mod_torch(torch.from_numpy(keys.astype(np.int64)), seed,
                         mod).numpy(), h)


def _flows():
    return st.lists(st.tuples(st.integers(1, 1000), st.integers(1, 500)),
                    min_size=1, max_size=50, unique_by=lambda t: t[0])


@settings(deadline=None, max_examples=25)
@given(_flows(), st.integers(0, 1000))
def test_cms_point_query_overestimates(flows, seed):
    """CMS invariant: estimate >= true count, for ANY stream."""
    keys = np.array([k for k, _ in flows], np.uint32)
    vals = np.array([v for _, v in flows], np.int64)
    spec = S.SketchSpec("cms", depth=3, width=32, seed=seed)
    c = S.update(spec, S.make_counters(spec, device="cpu"), keys, vals)
    est = S.query(spec, c, keys)
    assert (est >= vals - 1e-9).all()
    rspec = RS.SketchSpec("cms", depth=3, width=32, seed=seed)
    rc = RS.update(rspec, RS.make_counters(rspec), keys, vals)
    np.testing.assert_array_equal(c.numpy(), rc)
    np.testing.assert_array_equal(est, RS.query(rspec, rc, keys))


@settings(deadline=None, max_examples=25)
@given(_flows(), st.integers(0, 1000))
def test_sketch_linearity_property(flows, seed):
    """sketch(A) + sketch(B) == sketch(A + B) for any split."""
    keys = np.array([k for k, _ in flows], np.uint32)
    vals = np.array([v for _, v in flows], np.int64)
    spec = S.SketchSpec("cs", depth=3, width=16, seed=seed)
    cut = len(keys) // 2
    a = S.update(spec, S.make_counters(spec, device="cpu"), keys[:cut],
                 vals[:cut])
    b = S.update(spec, S.make_counters(spec, device="cpu"), keys[cut:],
                 vals[cut:])
    ab = S.update(spec, S.make_counters(spec, device="cpu"), keys, vals)
    assert torch.equal(a + b, ab)
    rspec = RS.SketchSpec("cs", depth=3, width=16, seed=seed)
    np.testing.assert_array_equal(
        ab.numpy(), RS.update(rspec, RS.make_counters(rspec), keys, vals))


@settings(deadline=None, max_examples=20)
@given(st.integers(0, 2**20), st.sampled_from([1, 2, 4, 8, 16]))
def test_subepoch_bitslice_property(ts, n):
    """Method 2 bit-slice == arithmetic (t mod Te) // (Te/n), any t, n."""
    te = 1 << LOG2_TE
    t = np.array([ts], np.int64)
    got = int(packet_subepoch(t, 0, LOG2_TE, n)[0])
    assert got == (ts % te) // (te // n)
    assert got == int(RFR.packet_subepoch(t, 0, LOG2_TE, n)[0])


@settings(deadline=None, max_examples=20)
@given(st.integers(1, 512), st.floats(1e-3, 1e6), st.floats(1e-3, 1e6))
def test_next_n_moves_toward_target(n, peb, target):
    """Eq. 6 monotonicity: n grows iff error is too high, shrinks iff
    too low, and always stays a power of two in [1, N_MAX]."""
    n = 1 << (n.bit_length() - 1)  # snap to power of two
    n2 = EQ.next_n(n, peb, target)
    assert n2 & (n2 - 1) == 0
    if peb > 2 * target:
        assert n2 >= n
    elif peb < target / 2:
        assert n2 <= n
    else:
        assert n2 == n
    assert n2 == REQ.next_n(n, peb, target)


@settings(deadline=None, max_examples=15)
@given(st.integers(0, 100), st.sampled_from([1, 2, 4, 8]),
       st.integers(1, 6))
def test_query_epoch_mass_conservation(seed, n, n_frag):
    """For a uniform-rate flow and CMS fragments with no collisions, the
    composite epoch estimate equals the true count regardless of the
    (n, fragment-count) combination."""
    true = 1 << LOG2_TE  # one packet per time unit
    keys = np.full(true, 12345, np.uint32)
    vals = np.ones(true, np.int64)
    ts = np.arange(true, dtype=np.int64)
    recs, rrecs = [], []
    for f in range(n_frag):
        cfg = FragmentConfig(frag_id=f, kind="cms", memory_bytes=4 * 1024)
        recs.append(process_epoch(cfg, 0, n, keys, vals, ts, 0, LOG2_TE))
        rcfg = RFR.FragmentConfig(frag_id=f, kind="cms",
                                  memory_bytes=4 * 1024)
        rrecs.append(RFR.process_epoch(rcfg, 0, n, keys, vals, ts, 0,
                                       LOG2_TE))
    q = np.array([12345], np.uint32)
    est = Q.query_epoch(recs, q, "cms")
    assert est[0] == pytest.approx(true, rel=1e-9)
    np.testing.assert_array_equal(est, RQ.query_epoch(rrecs, q, "cms"))


@settings(deadline=None, max_examples=25)
@given(st.lists(st.integers(0, 1000), min_size=1, max_size=64),
       st.sampled_from(["cs", "cms"]))
def test_peb_row_nonnegative_and_scale(counters, kind):
    c = np.array(counters, np.int64)
    rho = EQ.peb_row(c, kind)
    assert rho >= 0
    # doubling all counters doubles the PEB (both norms are 1-homogeneous)
    assert EQ.peb_row(2 * c, kind) == pytest.approx(2 * rho, rel=1e-9)
    assert rho == REQ.peb_row(c, kind)


@settings(deadline=None, max_examples=10)
@given(st.integers(0, 2**31 - 1))
def test_synthetic_data_in_vocab(seed):
    d = SyntheticLM(vocab=777, seq_len=8, batch_per_host=2, seed=seed)
    b = d.batch(0)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 777
    want = RSyntheticLM(vocab=777, seq_len=8, batch_per_host=2,
                        seed=seed).batch(0)
    assert b.keys() == want.keys()
    for k in b:
        np.testing.assert_array_equal(b[k], want[k])


# -- the device merge --------------------------------------------------------

def _merge_case(mask_bits, kind, seed, perm=None):
    """The reference property's window: (E=2) x (F=6) rows of n_sub 4 and
    width 256, fragment ``perm[slot]`` at each row slot, the liveness mask
    drawn from ``mask_bits``."""
    e_count, n_frags, n_sub, width = 2, 6, 4, 256
    rng = np.random.RandomState(seed % 2**31)
    perm = np.arange(n_frags) if perm is None else perm(rng, n_frags)
    sel = np.array([(mask_bits >> i) & 1 for i in range(e_count * n_frags)],
                   bool).reshape(e_count, n_frags)[:, perm]
    stack = rng.randint(-200, 200,
                        (e_count, n_frags, n_sub, width)).astype(np.float32)
    if kind == "cms":
        stack = np.abs(stack)
    params = np.zeros((e_count, n_frags, FK.N_PARAMS), np.int32)
    for e in range(e_count):
        for f_slot, f in enumerate(perm):
            params[e, f_slot, FK.PARAM_COL_SEED] = 11 + 17 * e + f
            params[e, f_slot, FK.PARAM_SIGN_SEED] = 22 + 17 * e + f
            params[e, f_slot, FK.PARAM_SUB_SEED] = 33 + 17 * e + f
            params[e, f_slot, FK.PARAM_WIDTH] = width
            params[e, f_slot, FK.PARAM_N_SUB] = n_sub
            params[e, f_slot, FK.PARAM_LOG2_N_SUB] = 2
    keys = rng.randint(0, 1 << 20, 16).astype(np.uint32)
    return rng, stack, params, sel, keys


def _host_oracle(stack, params, keys, kind, sel):
    """The reference's numpy ``fleet_query_epoch``, summed over epochs."""
    widths = params[0, :, FK.PARAM_WIDTH].astype(np.int64)
    return sum(RQ.fleet_query_epoch(
        stack[e], params[e, :, FK.PARAM_COL_SEED],
        params[e, :, FK.PARAM_SIGN_SEED], params[e, :, FK.PARAM_SUB_SEED],
        params[e, :, FK.PARAM_N_SUB].astype(np.int64), widths, keys,
        kind, frag_sel=sel[e]) for e in range(len(stack)))


@settings(deadline=None, max_examples=20)
@given(st.integers(0, 2**12 - 1),          # (E=2) x (F=6) liveness bitmask
       st.sampled_from(["cs", "cms"]),
       st.integers(0, 2**31 - 1))
def test_masked_merge_matches_numpy_oracle(mask_bits, kind, seed):
    """The device ``_masked_merge`` under ANY per-epoch fragment mask —
    odd or even survivor counts (cs masked median), any survivor subset
    (cms masked min) — matches the numpy oracle on the survivors; an
    epoch with no survivor fails loudly."""
    _, stack, params, sel, keys = _merge_case(mask_bits, kind, seed)
    t = torch.from_numpy(stack)
    if not sel.any(axis=1).all():
        with pytest.raises(ValueError, match="no on-path fragment"):
            fleet_window_query_device(t, list(params), keys, kind,
                                      frag_sel=sel)
        return
    got = fleet_window_query_device(t, list(params), keys, kind,
                                    frag_sel=sel)
    np.testing.assert_allclose(got, _host_oracle(stack, params, keys, kind,
                                                 sel), rtol=1e-6)


@settings(deadline=None, max_examples=15)
@given(st.integers(0, 2**12 - 1),          # (E=2) x (F=6) liveness bitmask
       st.sampled_from(["cs", "cms"]),
       st.sampled_from([2, 4, 8]),
       st.integers(0, 2**31 - 1))
def test_sharded_merge_matches_host_oracle(mask_bits, kind, n_shards, seed):
    """The cross-device merge, for ANY fragment->shard assignment (a
    random permutation of the fragment rows cut into ``n_shards``
    contiguous blocks, so a shard holds a random fragment subset and may
    be empty) and ANY liveness mask: bit-equal to the single-device query
    and allclose to the reference's host ``fleet_query_epoch``;
    all-masked epochs still raise."""
    rng, stack, params, sel, keys = _merge_case(
        mask_bits, kind, seed, perm=lambda r, n: r.permutation(n))
    cuts = np.sort(rng.randint(0, len(params[0]) + 1, n_shards - 1))
    blocks = np.split(np.arange(len(params[0])), cuts)
    t = torch.from_numpy(stack)
    groups = [(rows, t[:, rows].clone()) for rows in blocks if len(rows)]
    if not sel.any(axis=1).all():
        with pytest.raises(ValueError, match="no on-path fragment"):
            fleet_window_query_device(groups, list(params), keys, kind,
                                      frag_sel=sel)
        return
    got = fleet_window_query_device(groups, list(params), keys, kind,
                                    frag_sel=sel)
    single = fleet_window_query_device(t, list(params), keys, kind,
                                       frag_sel=sel)
    np.testing.assert_array_equal(got, single)
    np.testing.assert_allclose(got, _host_oracle(stack, params, keys, kind,
                                                 sel), rtol=1e-6)


# -- durable export plane ------------------------------------------------------

_EXPORT_SW = 3
_EXPORT_EPOCHS = 2


def _export_streams(epoch, seed, cls=SwitchStream):
    r = np.random.default_rng(seed)
    return {sw: cls(
        r.integers(0, 30, 40).astype(np.uint32),
        np.ones(40, np.int64),
        ((epoch << LOG2_TE)
         + np.sort(r.integers(0, 1 << LOG2_TE, 40)).astype(np.int64)))
        for sw in range(_EXPORT_SW)}


def _export_system(cls=DiSketchSystem, rho=5.0):
    return cls({sw: 128 for sw in range(_EXPORT_SW)}, "cms",
               rho_target=rho, log2_te=LOG2_TE, backend="loop")


@settings(deadline=None, max_examples=20)
@given(st.floats(0.0, 1.0), st.floats(0.0, 1.0), st.floats(0.0, 1.0),
       st.integers(0, 2**16), st.integers(0, 6))
def test_export_drain_invariants(p_drop, p_dup, p_reorder, seed,
                                 max_retries):
    """For ANY seeded drop/dup/reorder/delay pattern and ANY retry
    budget, a drained collector partitions the staged cells into
    applied | lost exactly; applied cells are bit-identical to a
    lossless oracle's; a loss-free drain reproduces the oracle's queries
    bit for bit; and ``stats()``, the applied and lost sets are the
    reference plane's."""
    oracle = _export_system()
    for e in range(_EXPORT_EPOCHS):
        oracle.run_epoch(e, _export_streams(e, 900 + e))
    planes = []
    for plane_cls, chan, sys_cls, stream in (
            (DurableExportPlane, LossyChannel, DiSketchSystem, SwitchStream),
            (RPlane, RChannel, RSystem, RStream)):
        plane = plane_cls(
            _export_system(sys_cls),
            chan(p_drop=p_drop, p_dup=p_dup, p_reorder=p_reorder,
                 delay=(0, 2), seed=seed),
            chan(p_drop=0.5 * p_drop, p_dup=p_dup, seed=seed + 1),
            max_retries=max_retries)
        for e in range(_EXPORT_EPOCHS):
            plane.run_epoch(e, _export_streams(e, 900 + e, stream))
        plane.drain()
        planes.append(plane)
    plane, ref = planes

    staged = {(sw, e) for sw in range(_EXPORT_SW)
              for e in range(_EXPORT_EPOCHS)}
    applied = set(plane.collector.applied)
    lost = plane.lost_cells()
    assert applied | lost == staged
    assert not (applied & lost)
    assert plane.pending_cells() == set()
    # exactly the exhausted, never-delivered cells are reported lost
    assert lost == {(sw, e) for sw, exp in plane.exporters.items()
                    for e in exp.exhausted_epochs()
                    if (sw, e) not in applied}
    for sw, e in applied:
        assert np.array_equal(
            np.asarray(plane.system.records[e][sw].counters),
            np.asarray(oracle.records[e][sw].counters)), (sw, e)
    assert plane.stats() == ref.stats()
    assert applied == set(ref.collector.applied)
    assert lost == ref.lost_cells()
    if not lost:
        keys = np.arange(30).astype(np.uint32)
        paths = [tuple(range(_EXPORT_SW))] * len(keys)
        epochs = list(range(_EXPORT_EPOCHS))
        assert np.array_equal(
            plane.query_flows(keys, paths, epochs, failures="mask"),
            oracle.query_flows(keys, paths, epochs, failures="mask"))


# -- lossy channel semantics ---------------------------------------------------

@settings(deadline=None, max_examples=40)
@given(st.floats(0.0, 1.0), st.floats(0.0, 1.0), st.floats(0.0, 1.0),
       st.integers(0, 2**16), st.integers(1, 24), st.integers(0, 4))
def test_channel_delay_beyond_drain_reported_not_dropped(
        p_drop, p_dup, p_reorder, seed, n_msgs, drain_round):
    """For ANY channel parameters, a drain loop that stops at round T
    must see every still-in-flight message in ``undelivered()`` —
    delayed-past-the-horizon is an explicit state, never a silent drop.
    Conservation holds at every round: sent - dropped + dup ==
    delivered + pending.  Every delivery is the reference channel's."""
    chans = []
    for chan, ack in ((LossyChannel, AckMsg), (RChannel, RAckMsg)):
        ch = chan(p_drop=p_drop, p_dup=p_dup, p_reorder=p_reorder,
                  delay=(0, 3), seed=seed)
        for i in range(n_msgs):
            ch.send(ack(frag=i % 5, epoch=i // 5, seq=i), now=i % 3)
        chans.append(ch)
    ch, ref = chans
    for r in range(drain_round + 1):
        got = [(m.frag, m.epoch, m.seq) for m in ch.deliver(r)]
        assert got == [(m.frag, m.epoch, m.seq) for m in ref.deliver(r)]
    assert (ch.n_sent - ch.n_dropped + ch.n_dup
            == ch.n_delivered + ch.pending())
    und = ch.undelivered()
    assert len(und) == ch.pending()
    rounds = [r for r, _ in und]
    assert rounds == sorted(rounds)            # soonest first
    assert all(r > drain_round for r in rounds)  # due ones were popped
    assert rounds == [r for r, _ in ref.undelivered()]
    # extending the drain past the horizon delivers exactly them
    if und:
        late = ch.deliver(rounds[-1])
        assert len(late) == len(und)
        assert ch.pending() == 0 and ch.undelivered() == []


# -- §6 re-equalization --------------------------------------------------------

@settings(deadline=None, max_examples=40)
@given(st.dictionaries(st.integers(0, 15),
                       st.tuples(st.sampled_from([1, 2, 4, 8, 16, 64]),
                                 st.floats(1e-3, 1e5)),
                       min_size=1, max_size=8),
       st.floats(1e-2, 1e4))
def test_reequalize_properties(fleet, rho):
    """§6 re-equalization, for ANY fleet state: (a) it touches subepoch
    counts only — the per-switch set and every fragment's memory are
    conserved; (b) each n_i is a power of two in [1, N_MAX] and is
    monotone in that switch's PEB; (c) on a converged fleet (PEBs
    updated under the peb * n/n' model) it is idempotent; and it is the
    reference's."""
    ns = {sw: n for sw, (n, _) in fleet.items()}
    pebs = {sw: p for sw, (_, p) in fleet.items()}
    ns2 = EQ.reequalize(ns, pebs, rho)
    assert ns2 == REQ.reequalize(ns, pebs, rho)
    assert set(ns2) == set(ns)                        # switch set conserved
    for sw, n2 in ns2.items():
        assert 1 <= n2 <= EQ.N_MAX and n2 & (n2 - 1) == 0
        # monotone in PEB: a worse-bound fragment never subdivides less
        assert EQ.converge_n(ns[sw], 2.0 * pebs[sw], rho) >= n2
        assert EQ.converge_n(ns[sw], 2.0 * pebs[sw], rho) == \
            REQ.converge_n(ns[sw], 2.0 * pebs[sw], rho)
    # idempotent once the PEBs reflect the applied counts (Eq. 4 model:
    # peb scales as n/n')
    pebs2 = {sw: pebs[sw] * ns[sw] / ns2[sw] for sw in pebs}
    assert EQ.reequalize(ns2, pebs2, rho) == ns2


def test_reequalize_conserves_fleet_memory():
    """System-level: §6 re-equalization after a death re-tunes subepoch
    counts but never moves memory between switches — the survivors'
    fragment bytes (and widths) are exactly what they were, and the
    counts are the reference's."""
    s = _export_system(rho=0.05)
    ref = _export_system(RSystem, rho=0.05)
    for e in range(3):
        s.run_epoch(e, _export_streams(e, 70 + e))
        ref.run_epoch(e, _export_streams(e, 70 + e, RStream))
    assert any(n > 1 for n in s.ns.values())  # Eq. 6 actually engaged
    before = {sw: (cfg.memory_bytes, cfg.width)
              for sw, cfg in s.fragments.items()}
    ns_before = dict(s.ns)
    s.apply_event(FailureEvent(2, 0, "fail"))
    assert {sw: (cfg.memory_bytes, cfg.width)
            for sw, cfg in s.fragments.items()} == before
    assert set(s.ns) == set(ns_before)
    changed = [sw for sw in s.ns if s.ns[sw] != ns_before[sw]]
    assert 0 not in changed                 # the dead switch is held out
    ref.apply_event(RFailureEvent(2, 0, "fail"))
    assert s.ns == ref.ns
