"""Switch churn and failure recovery in the port, against the JAX package.

A dead switch keeps forwarding but its sketch resource is reclaimed: the
fleet masks its packets to value 0, so its rows come out exactly zero, and
the liveness registry keeps it out of the queries and the §4.2 control.
A switch that dies inside a window also loses its earlier epochs of that
window; XOR parity over a group of fragments rebuilds one lost cell per
group and epoch.

The reference's fleet backend cannot run on this CPU (its Pallas calls
fail under this jax), so the port is held to:

* the reference's loop backend, which runs churn per epoch (dead skip,
  ``_dead_at``, ``ns``, re-equalization, the masked record plane);
* for what only the window path has (lost cells, parity, ``recover``, the
  device masks), ``ChurnWindowEmulation`` of ``scripts/reference_pins.py``:
  the reference's ``process_epoch`` with ``ns`` frozen per window, its own
  ``apply_event`` for the control, and its numpy ``query_window``.

Counters must be bit-identical, estimates within 1e-6 relative, and the
``n`` trajectories, dead sets, clamps and observability exactly equal.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import equalize as REQ
from repro.core import fleet as RF
from repro.core import query as RQ
from repro.core.disketch import AggregatedSystem as RAggregated
from repro.core.disketch import DiscoSystem as RDisco
from repro.core.disketch import DiSketchSystem as RSystem
from repro.core.disketch import SwitchStream as RStream
from repro.core.hashing import level_of
from repro.net import simulator as RS
from repro.net.topology import FatTree as RFatTree
from repro.net.traffic import gen_workload as r_gen_workload
from repro.runtime.fault_tolerance import HeartbeatMonitor as RMonitor
from repro_torch.core import equalize as TEQ
from repro_torch.core.disketch import AggregatedSystem, DiscoSystem
from repro_torch.core.disketch import DiSketchSystem, SwitchStream
from repro_torch.core.fleet import (FleetPacket, mask_fragment_values,
                                    pack_streams, parity_groups_chunked)
from repro_torch.kernels.sketch_update.fleet import PARAM_N_SUB, PARAM_WIDTH
from repro_torch.net import simulator as TS
from repro_torch.net.topology import FatTree
from repro_torch.net.traffic import gen_workload
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
from reference_pins import ChurnWindowEmulation, n_log_digest  # noqa: E402

SW = 6
LOG2_TE = 10
MEMS = {sw: 256 for sw in range(SW)}
KEYS = np.arange(50).astype(np.uint32)
EPOCHS = [0, 1, 2, 3]


def streams_for(epoch, seed, cls=SwitchStream, n_pkts=200, n_keys=50):
    r = np.random.default_rng(seed)
    out = {}
    for sw in range(SW):
        keys = r.integers(0, n_keys, n_pkts).astype(np.uint32)
        ts = ((epoch << LOG2_TE)
              + np.sort(r.integers(0, 1 << LOG2_TE, n_pkts)).astype(
                  np.int64))
        out[sw] = cls(keys, np.ones(n_pkts, np.int64), ts)
    return out


def port(kind="cms", rho=5.0, backend="fleet", disco=False, mems=MEMS,
         **fleet_kw):
    cls = DiscoSystem if disco else DiSketchSystem
    kw = dict(device="cpu", fleet_kwargs=fleet_kw) if backend == "fleet" \
        else {}
    return cls(mems, kind, rho_target=rho, log2_te=LOG2_TE, backend=backend,
               **kw)


def ref(kind="cms", rho=5.0, disco=False):
    cls = RDisco if disco else RSystem
    return cls(MEMS, kind, rho_target=rho, log2_te=LOG2_TE)


def emulate(events_by_epoch, kind="cms", rho=5.0, window=4, n_epochs=4,
            parity_groups=None, **kw):
    """The reference's window path over ``streams_for`` epochs."""
    class Scripted:
        def advance(self, e):
            return list(events_by_epoch.get(e, ()))

    return ChurnWindowEmulation.replay(
        lambda e: streams_for(e, 100 + e, RStream), MEMS, kind, rho,
        LOG2_TE, n_epochs, window, Scripted(), parity_groups=parity_groups,
        **kw)


def run_window(system, events, n_epochs=4):
    system.run_window(0, [streams_for(e, 100 + e) for e in range(n_epochs)],
                      events_by_epoch=[events.get(e, []) for e in
                                       range(n_epochs)])


def ev(epoch, sw, kind, factor=1.0):
    return TS.FailureEvent(epoch, sw, kind, factor)


def assert_records_equal(got, want, epochs):
    for e in epochs:
        assert sorted(got[e]) == sorted(want[e]), e
        for sw in want[e]:
            assert got[e][sw].n == want[e][sw].n, (e, sw)
            np.testing.assert_array_equal(got[e][sw].counters,
                                          want[e][sw].counters)


def as_tuples(events):
    return [(e.epoch, e.switch, e.kind, e.factor) for e in events]


# -- schedules, detection, control helpers -----------------------------------

SCHEDULES = {
    "death-and-recovery": dict(args=(SW,), kw=dict(downs={2: (3, 6)})),
    "detection-lag": dict(args=(SW,), kw=dict(downs={4: (2, None)},
                                              timeout_s=1.5)),
    "resizes": dict(args=(SW,), kw=dict(shrinks=[(2, 1, 0.5),
                                                 (3, 1, 2.0)])),
    "random": dict(random=True),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_failure_schedule_matches_reference(name):
    """FailureSchedule's detected events (deaths, recoveries, the
    detection lag of a slow timeout, scripted resizes) and its ground
    truth equal the reference's."""
    case = SCHEDULES[name]
    if case.get("random"):
        got = TS.FailureSchedule.random(20, 0.25, down_epoch=5, up_epoch=7,
                                        seed=3)
        want = RS.FailureSchedule.random(20, 0.25, down_epoch=5, up_epoch=7,
                                         seed=3)
    else:
        got = TS.FailureSchedule(*case["args"], **case["kw"])
        want = RS.FailureSchedule(*case["args"], **case["kw"])
    for e in range(10):
        assert as_tuples(got.advance(e)) == as_tuples(want.advance(e)), e
        for sw in range(got.n_switches):
            assert got.is_up(sw, e) == want.is_up(sw, e)
    assert as_tuples(got.log) == as_tuples(want.log)
    if name == "detection-lag":
        assert [x.epoch for x in got.log if x.kind == "fail"] == [3]


@pytest.mark.parametrize("bad", [
    dict(downs={SW: (1, None)}), dict(downs={0: (3, 2)}),
    dict(shrinks=[(1, 0, 0.0)]), dict(shrinks=[(1, 0, -0.5)])])
def test_failure_schedule_validation_matches_reference(bad):
    with pytest.raises(ValueError) as want:
        RS.FailureSchedule(SW, **bad)
    with pytest.raises(ValueError) as got:
        TS.FailureSchedule(SW, **bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_resource_pressure_and_composition_match_reference(seed):
    """ResourcePressure's seeded grabs and releases, and a
    ComposedSchedule of it with a FailureSchedule, emit the reference's
    event streams."""
    got = TS.ResourcePressure(20, horizon=32, seed=seed)
    want = RS.ResourcePressure(20, horizon=32, seed=seed)
    tc = TS.ComposedSchedule([
        TS.FailureSchedule.random(20, 0.25, down_epoch=17, up_epoch=25,
                                  seed=seed),
        TS.ResourcePressure(20, horizon=32, seed=seed)])
    rc = RS.ComposedSchedule([
        RS.FailureSchedule.random(20, 0.25, down_epoch=17, up_epoch=25,
                                  seed=seed),
        RS.ResourcePressure(20, horizon=32, seed=seed)])
    kinds = set()
    for e in range(32):
        a = got.advance(e)
        assert as_tuples(a) == as_tuples(want.advance(e))
        assert as_tuples(tc.advance(e)) == as_tuples(rc.advance(e))
        kinds |= {x.kind for x in a}
    assert kinds == {"shrink", "grow"}
    assert as_tuples(tc.log) == as_tuples(rc.log)


@pytest.mark.parametrize("bad", [dict(p_grab=1.5),
                                 dict(grab_frac=(0.0, 0.5)),
                                 dict(hold=(0, 2))])
def test_resource_pressure_validation_matches_reference(bad):
    with pytest.raises(ValueError) as want:
        RS.ResourcePressure(4, horizon=8, **bad)
    with pytest.raises(ValueError) as got:
        TS.ResourcePressure(4, horizon=8, **bad)
    assert str(got.value) == str(want.value)


def test_heartbeat_monitor_matches_reference():
    """Timeout transitions under an injected clock, and the range check."""
    t = [0.0]
    got = HeartbeatMonitor(4, timeout_s=1.0, clock=lambda: t[0])
    want = RMonitor(4, timeout_s=1.0, clock=lambda: t[0])
    for step in range(8):
        t[0] = float(step)
        for h in range(4):
            if (h + step) % 3:
                got.beat(h)
                want.beat(h)
        assert got.failed_hosts() == want.failed_hosts()
        assert got.healthy_hosts() == want.healthy_hosts()
    with pytest.raises(ValueError, match="out of range"):
        got.beat(4)


CONVERGE = [(n0, peb, rho) for n0 in (1, 8, 64, 1024)
            for peb in (0.0, 0.5, 4.0, 100.0, 1e6, float("inf"))
            for rho in (0.5, 4.0)]


@pytest.mark.parametrize("n0,peb,rho", CONVERGE[::2])
def test_converge_n_matches_reference(n0, peb, rho):
    n = TEQ.converge_n(n0, peb, rho)
    assert n == REQ.converge_n(n0, peb, rho)
    if 0 < peb < float("inf"):
        predicted = peb * n0 / n
        assert (rho / 2 <= predicted <= 2 * rho) or n in (1, TEQ.N_MAX)
        assert TEQ.converge_n(n, predicted, rho) == n     # idempotent


def test_reequalize_matches_reference():
    rng = np.random.default_rng(7)
    for _ in range(20):
        ns = {sw: int(2 ** rng.integers(0, 8)) for sw in range(8)}
        pebs = {sw: float(rng.lognormal(1, 2)) for sw in range(8)
                if rng.random() < 0.7}
        assert TEQ.reequalize(ns, pebs, 4.0) == REQ.reequalize(ns, pebs, 4.0)
    out = TEQ.reequalize({0: 4, 1: 4, 2: 4}, {0: 100.0, 1: 5.0}, 4.0)
    assert out[0] > 4 and out[1] == 4 and out[2] == 4


def test_parity_groups_and_masking_match_reference():
    """``parity_groups_chunked`` and ``mask_fragment_values`` (value-0
    segments, keys and ts shared, offsets unchanged) equal the
    reference's."""
    for order, size in (((0, 1, 2, 3, 4), 2), (tuple(range(20)), 5),
                        ((3, 1), 4)):
        assert parity_groups_chunked(order, size) == \
            RF.parity_groups_chunked(order, size)
    with pytest.raises(ValueError):
        parity_groups_chunked((0, 1), 0)
    rng = np.random.default_rng(3)
    lens = np.array([5, 0, 7, 3])
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    n = int(offs[-1])
    args = (rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32),
            rng.integers(1, 4, n).astype(np.int64),
            rng.integers(0, 1 << 20, n).astype(np.int64), offs, (0, 1, 2, 3))
    got = mask_fragment_values(FleetPacket(*args), [0, 2])
    want = RF.mask_fragment_values(RF.FleetPacket(*args), [0, 2])
    np.testing.assert_array_equal(got.values, want.values)
    assert got.keys is args[0] and got.ts is args[2]
    assert (got.values[:5] == 0).all() and (got.values[12:] != 0).all()
    assert mask_fragment_values(FleetPacket(*args), []).values is args[1]


def test_nrmse_and_are_match_reference():
    rng = np.random.default_rng(1)
    est, truth = rng.normal(10, 3, 100), rng.integers(0, 20, 100)
    assert TS.nrmse(est, truth, 1234.0) == RS.nrmse(est, truth, 1234.0)
    assert TS.are(est, truth) == RS.are(est, truth)


def test_aggregated_system_rejects_events():
    agg = AggregatedSystem({16: 4096}, "cms", device="cpu")
    with pytest.raises(ValueError, match="no churn"):
        agg.run_epoch(0, {}, events=[ev(0, 16, "fail")])
    agg.run_epoch(0, {}, events=[])        # no events is fine
    with pytest.raises(ValueError, match="no churn"):
        RAggregated({16: 4096}, "cms").run_epoch(
            0, {}, events=[RS.FailureEvent(0, 16, "fail")])


# -- per-epoch churn: the port's backends against the reference's loop -------

EPOCH_CASES = {
    "fleet-cs": ("cs", dict(backend="fleet", keep_stacked=True)),
    "fleet-cms": ("cms", dict(backend="fleet", keep_stacked=True)),
    "dense-cs": ("cs", dict(backend="fleet", layout="dense")),
    "dense-cms": ("cms", dict(backend="fleet", layout="dense")),
    "loop-cs": ("cs", dict(backend="loop")),
    "loop-cms": ("cms", dict(backend="loop")),
    "disco-cms": ("cms", dict(backend="fleet", disco=True)),
}
# deaths (one recovering), a detection at the epoch's start, resizes both
# ways, and a shrink of a dead switch
EPOCH_SCHEDULE = dict(downs={3: (1, 4), 0: (2, None)},
                      shrinks=[(1, 2, 0.5), (3, 2, 2.0), (2, 0, 0.5),
                               (4, 5, 0.25)])


@pytest.mark.parametrize("name", sorted(EPOCH_CASES))
def test_per_epoch_churn_matches_reference_loop(name):
    """Per-epoch churn on the port's ragged (B1) and dense (B3) fleet, its
    loop backend and DISCO, against the reference's loop backend: records
    bit-identical (dead switches have none), ``ns``, ``n_log``,
    ``_dead_at``, ``clamp_log`` and ``observability`` equal, PEBs and every
    policy's estimates on both merges within 1e-6 — on the device plane
    too, where ``keep_stacked`` keeps the epochs there."""
    kind, kw = EPOCH_CASES[name]
    kw = dict(kw)
    disco = kw.pop("disco", False)
    got = port(kind, rho=2.0, disco=disco, **kw)
    want = ref(kind, rho=2.0, disco=disco)
    t_sched = TS.FailureSchedule(SW, **EPOCH_SCHEDULE)
    r_sched = RS.FailureSchedule(SW, **EPOCH_SCHEDULE)
    n_epochs = 6
    for e in range(n_epochs):
        got.run_epoch(e, streams_for(e, 100 + e),
                      events=t_sched.advance(e))
        want.run_epoch(e, streams_for(e, 100 + e, RStream),
                       events=r_sched.advance(e))
        assert got.ns == want.ns, e
    epochs = list(range(n_epochs))
    assert got._dead_at == want._dead_at and got._dead_at
    assert got.n_log == want.n_log
    assert got.clamp_log == want.clamp_log
    assert {sw: c.width for sw, c in got.fragments.items()} == \
        {sw: c.width for sw, c in want.fragments.items()}
    assert_records_equal(got.records, want.records, epochs)
    for a, b in zip(got.peb_log, want.peb_log):
        assert sorted(a) == sorted(b)
        for sw in b:
            assert a[sw] == pytest.approx(b[sw], rel=1e-6)
    assert got.observability(epochs) == want.observability(epochs)
    device = kw.get("keep_stacked", False)
    for path in [(2, 3), (0, 1), (3,), (0, 3, 5)]:
        paths = [path] * len(KEYS)
        for merge in ("subepoch", "fragment"):
            for failures in ("oblivious", "mask", "recover"):
                a = got.query_flows(KEYS, paths, epochs, merge=merge,
                                    failures=failures)
                b = want.query_flows(KEYS, paths, epochs, merge=merge,
                                     failures=failures)
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
                assert got.last_observability == want.last_observability
        if device:
            assert got.fleet.has_device_window(epochs)


def test_oblivious_does_not_extrapolate_blind_epochs():
    """The repaired fault C8: under "oblivious" the record plane sums the
    observed epochs as they are, without the blind-epoch scale E /
    E_observable that "mask" applies, as the reference does."""
    events = {2: [ev(2, 3, "fail")]}
    r_events = {2: [RS.FailureEvent(2, 3, "fail")]}
    want = ref()
    for e in EPOCHS:
        want.run_epoch(e, streams_for(e, 100 + e, RStream),
                       events=r_events.get(e))
    paths = [(3,)] * len(KEYS)
    for backend in ("fleet", "loop"):
        got = port(backend=backend)
        for e in EPOCHS:
            got.run_epoch(e, streams_for(e, 100 + e), events=events.get(e))
        obl = got.query_flows(KEYS, paths, EPOCHS, failures="oblivious")
        np.testing.assert_array_equal(
            obl, want.query_flows(KEYS, paths, EPOCHS, failures="oblivious"))
        msk = got.query_flows(KEYS, paths, EPOCHS, failures="mask")
        np.testing.assert_allclose(msk, 2.0 * obl, rtol=1e-12)
        want.query_flows(KEYS, paths, EPOCHS, failures="mask")
        assert got.last_observability == want.last_observability


def test_off_path_death_leaves_survivors_bit_identical():
    """A death off the queried path perturbs no bit of the survivors, per
    epoch and in a window: their counters, the n control and the
    estimates equal a fleet that never failed."""
    churned, clean = port(), port()
    for e in EPOCHS:
        churned.run_epoch(e, streams_for(e, 100 + e),
                          events=[ev(2, 3, "fail")] if e == 2 else None)
        clean.run_epoch(e, streams_for(e, 100 + e))
    w_churned, w_clean = port(), port()
    run_window(w_churned, {2: [ev(2, 3, "fail")]})
    run_window(w_clean, {})
    paths = [(0, 1)] * len(KEYS)
    assert churned.ns == clean.ns and churned.n_log == clean.n_log
    for a, b, merge in ((churned, clean, "subepoch"),
                        (w_churned, w_clean, "fragment")):
        np.testing.assert_array_equal(
            a.query_flows(KEYS, paths, EPOCHS, merge=merge),
            b.query_flows(KEYS, paths, EPOCHS, merge=merge))
        for e in EPOCHS:
            for sw in (0, 1, 2, 4, 5):
                np.testing.assert_array_equal(a.records[e][sw].counters,
                                              b.records[e][sw].counters)


def test_failure_reequalizes_survivors_and_recovery_restarts_at_n0():
    """A "fail" jumps the out-of-band survivors to Eq. 6's fixed point in
    one step; a "recover" rejoins the switch at n = 1; both as the
    reference's loop backend does, on the port's fleet."""
    got, want = port(rho=0.5), ref(rho=0.5)
    events = {2: [(2, 0, "fail")], 3: [(3, 4, "fail")],
              4: [(4, 0, "recover")]}
    for e in range(6):
        got.run_epoch(e, streams_for(e, 100 + e),
                      events=[ev(*x) for x in events.get(e, ())])
        want.run_epoch(e, streams_for(e, 100 + e, RStream),
                       events=[RS.FailureEvent(*x)
                               for x in events.get(e, ())])
        assert got.ns == want.ns and got.n_log == want.n_log, e
    assert max(got.n_log[1].values()) > 1       # the control had moved
    # the jump at the failure: converge_n against the last PEBs, then Eq. 6
    last = {sw: p for log in got.peb_log[:2] for sw, p in log.items()}
    for sw in range(1, SW):
        expect = TEQ.converge_n(got.n_log[1][sw], last[sw], 0.5)
        assert got.n_log[2][sw] == TEQ.next_n(expect, got.peb_log[2][sw],
                                              0.5)
    assert 0 not in got.peb_log[2] and 0 in got.peb_log[4]
    assert got.records[4][0].n == 1             # restarted at n_0
    assert got._valid(0, 4) and not got._valid(0, 3)


@pytest.mark.parametrize("factor", [0.25, 2.0])
def test_mid_window_resize_defers_to_next_dispatch(factor):
    """A shrink or grow inside a window waits for the next dispatch (the
    window's widths are frozen), lands there, and leaves the past
    window's records, hash moduli and queries as they were."""
    s = port()
    w0 = s.fragments[1].width
    run_window(s, {1: [ev(1, 1, "shrink" if factor < 1 else "grow",
                          factor)]})
    assert s.fragments[1].width == w0 and s._pending_resize == {1: factor}
    em = emulate({1: [RS.FailureEvent(1, 1, "shrink" if factor < 1
                                      else "grow", factor)]})
    before = s.query_flows(KEYS, [(1, 2)] * len(KEYS), EPOCHS,
                           merge="fragment")
    s.run_epoch(4, streams_for(4, 104))         # the boundary: it lands
    w1 = int(w0 * factor)
    assert s.fragments[1].width == w1 and s.records[4][1].counters.shape \
        == (s.records[4][1].n, w1)
    assert int(s.fleet.widths[s.fleet._frag_pos[1]]) == w1
    for e in EPOCHS:
        assert s.records[e][1].counters.shape[-1] == w0
    np.testing.assert_array_equal(
        s.query_flows(KEYS, [(1, 2)] * len(KEYS), EPOCHS, merge="fragment"),
        before)
    np.testing.assert_allclose(
        before, em.query(KEYS, [(1, 2)] * len(KEYS), EPOCHS, "mask"),
        rtol=1e-6, atol=1e-6)
    assert s.n_log[:4] == em.ctl.n_log


def test_width_clamp_recorded_in_clamp_log():
    """A shrink after the last PEB makes it stale: re-equalization
    converges against the width-scaled bound, and the clamp (intended
    against applied n) is recorded as the reference records it."""
    got, want = port(rho=0.5), ref(rho=0.5)
    for e in range(2):
        got.run_epoch(e, streams_for(e, 100 + e))
        want.run_epoch(e, streams_for(e, 100 + e, RStream))
    for s, mk in ((got, ev), (want, RS.FailureEvent)):
        s.apply_event(mk(2, 1, "shrink", 0.25))
        s.apply_event(mk(2, 2, "fail"))
    assert got.clamp_log == want.clamp_log
    assert got.clamp_log and got.clamp_log[0]["switch"] == 1
    assert got.ns == want.ns
    assert got.observability([0, 1]) == want.observability([0, 1])
    assert got.observability([0, 1])["config_clamps"] == got.clamp_log


# -- the window path: dead and lost cells, parity -----------------------------

def test_lost_cells_zeroed_and_masked():
    """A death at window offset 2 loses the victim's epochs 0 and 1: their
    counters are zeroed, the cells masked on both planes, and the masked
    estimate is the survivors-only answer of the reference's emulation."""
    s = port()
    run_window(s, {2: [ev(2, 3, "fail")]})
    em = emulate({2: [RS.FailureEvent(2, 3, "fail")]})
    assert {e: {s.fleet.frag_order[i] for i in v}
            for e, v in s.fleet._lost.items()} == em.lost == {0: {3}, 1: {3}}
    assert s._dead_at == em.ctl._dead_at
    for e in EPOCHS:
        assert not s.fleet.frag_live(e)[3]
    paths = [(2, 3)] * len(KEYS)
    want = em.query(KEYS, paths, EPOCHS, "mask")
    np.testing.assert_allclose(
        s.query_flows(KEYS, paths, EPOCHS, merge="fragment"), want,
        rtol=1e-6)
    assert s.fleet._window_bufs[0][0].resident
    for e in EPOCHS:                         # the record plane's copy
        assert not s.records[e][3].counters.any()
        np.testing.assert_array_equal(s.records[e][2].counters,
                                      em.ctl.records[e][2].counters)
    np.testing.assert_allclose(
        s.query_flows(KEYS, paths, EPOCHS, merge="fragment"), want,
        rtol=1e-6)
    np.testing.assert_allclose(
        s.query_flows(KEYS, paths, EPOCHS),
        em.query(KEYS, paths, EPOCHS, "mask", merge="subepoch"), rtol=1e-6)
    assert s.n_log == em.ctl.n_log and s.ns == em.ctl.ns


def _spread_fleet(parity_groups):
    """A fleet whose n spread over several row groups (widths from 16 to
    512 counters under the same load, after one window of control), then
    a window where switch 3 dies at offset 2; and its twin without the
    loss."""
    systems = []
    for lost in (True, False):
        s = port(rho=2.0, mems={sw: 64 << sw for sw in range(SW)},
                 parity_groups=parity_groups)
        s.run_window(0, [streams_for(e, 100 + e) for e in range(4)])
        sls = [streams_for(e, 100 + e) for e in range(4, 8)]
        if lost:
            s.run_window(4, sls, events_by_epoch=[
                [], [], [ev(6, 3, "fail")], []])
        else:                # the same dispatch, nothing lost
            recs, _ = s.fleet.run_window(
                4, s._control_ns(),
                [pack_streams(st, s.fleet.frag_order) for st in sls],
                dead_by_epoch=[set(), set(), {3}, {3}])
            s.records.update(zip(range(4, 8), recs))
        systems.append(s)
    return systems


@pytest.mark.parametrize("where", ["resident", "host"])
def test_parity_recovery_exact_through_row_groups(where):
    """XOR parity rebuilds the lost cells bit for bit, though the group's
    members sit in row groups of different (n, width): while the window is
    resident (the device plane) and after its host copy (the record
    views see the patch in place)."""
    groups = [list(range(SW))]
    s, twin = _spread_fleet(groups)
    fleet = s.fleet
    buf = fleet._window_bufs[4][0]
    ns = {int(fleet._params_log[4][i, PARAM_N_SUB]) for i in range(SW)}
    assert len(buf.device()) > 1 and len(ns) > 1   # several row groups
    assert fleet.recoverable() == {4: [3], 5: [3]}
    if where == "host":
        for e in (4, 5):
            assert not s.records[e][3].counters.any()
        assert not buf.resident
    keep = {e: s.records[e][3] for e in (4, 5)} if where == "host" else {}
    got = fleet.recover()
    assert got == {4: [3], 5: [3]} and fleet.recoverable() == {}
    assert buf.resident == (where == "resident")
    for e in range(4, 8):
        for sw in range(SW):
            np.testing.assert_array_equal(s.records[e][sw].counters,
                                          twin.records[e][sw].counters)
    for e, rec in keep.items():             # views handed out earlier
        np.testing.assert_array_equal(rec.counters,
                                      twin.records[e][3].counters)
    for e in (4, 5):
        assert fleet.frag_live(e).all()
    parity_bytes = sum(p.numel() * 4 for e in range(4, 8)
                       for p in fleet._parity[e])
    longest = max(int(fleet._params_log[4][i, PARAM_N_SUB])
                  * int(fleet._params_log[4][i, PARAM_WIDTH])
                  for i in range(SW))
    assert parity_bytes == 4 * 4 * longest     # 4 epochs x 1 group


def test_double_loss_in_group_stays_masked():
    """Two losses in one group and epoch cannot be rebuilt and stay
    masked; the same two in different groups are both rebuilt."""
    events = {1: [ev(1, 2, "fail"), ev(1, 3, "fail")]}
    both = port(parity_groups=[list(range(SW))])
    run_window(both, events)
    assert both.fleet.recoverable() == {} and both.fleet.recover() == {}
    r_events = {1: [RS.FailureEvent(1, 2, "fail"),
                    RS.FailureEvent(1, 3, "fail")]}
    em = emulate(r_events, parity_groups=[list(range(SW))])
    assert em.recoverable() == {}
    paths = [(1, 2, 3)] * len(KEYS)
    np.testing.assert_allclose(
        both.query_flows(KEYS, paths, EPOCHS, merge="fragment",
                         failures="recover"),
        em.query(KEYS, paths, EPOCHS, "recover"), rtol=1e-6)
    assert not both.fleet.frag_live(0)[2] and not both.fleet.frag_live(0)[3]
    split = port(parity_groups=[[0, 1, 2], [3, 4, 5]])
    run_window(split, events)
    assert split.fleet.recoverable() == {0: [2, 3]}
    assert split.fleet.recover() == {0: [2, 3]}
    em = emulate(r_events, parity_groups=[[0, 1, 2], [3, 4, 5]])
    em.recover()
    for sw in (2, 3):
        np.testing.assert_array_equal(split.records[0][sw].counters,
                                      em.ctl.records[0][sw].counters)


@pytest.mark.parametrize("plane", ["device", "host"])
def test_blind_epoch_extrapolation(plane):
    """A single-hop path dead for the back half of the window (the front
    half rebuilt from parity): the estimate is the observed half scaled by
    E / E_observable, on either plane, as the reference's emulation
    gives it."""
    groups = [list(range(SW))]
    s = port(parity_groups=groups)
    run_window(s, {2: [ev(2, 3, "fail")]})
    em = emulate({2: [RS.FailureEvent(2, 3, "fail")]},
                 parity_groups=groups)
    paths = [(3,)] * len(KEYS)
    if plane == "host":
        s.records[0][0]                      # the window's host copy
    got = s.query_flows(KEYS, paths, EPOCHS, merge="fragment",
                        failures="recover")
    np.testing.assert_allclose(got, em.query(KEYS, paths, EPOCHS,
                                             "recover"), rtol=1e-6)
    assert s.fleet.last_observability == {
        "epochs": 4, "observable_epochs": 2, "scale": 2.0} \
        or plane == "host"
    assert s.fleet._window_bufs[0][0].resident == (plane == "device")
    half = RQ.query_window([[em.ctl.records[e][3]] for e in (0, 1)], KEYS,
                           "cms", single_hop=np.ones(len(KEYS), bool),
                           merge="fragment")
    np.testing.assert_allclose(got, 2.0 * half, rtol=1e-9)


MIXED_PATHS = [(3,), (1,), (0, 3), (1, 3), (2, 4, 5), (1, 2)]


@pytest.mark.parametrize("kind", ["cs", "cms"])
@pytest.mark.parametrize("failures", ["oblivious", "mask", "recover"])
def test_grouped_window_query_matches_reference(kind, failures):
    """``query_flows`` answers every path of two windows in one gather a
    window (``window_query_groups``): single-hop and longer paths, switch
    3 dead from epoch 4 (paths through it alone blind there), switch 1
    dead from 6 with its epochs 4 and 5 lost (rebuilt under "recover").
    The answers equal the reference's emulation, and the same groups on
    the windows' host copies give the resident answers."""
    from repro_torch.core.query import path_groups

    groups = [list(range(SW))]
    s = port(kind, parity_groups=groups)
    s.run_window(0, [streams_for(e, 100 + e) for e in range(4)])
    s.run_window(4, [streams_for(e, 100 + e) for e in range(4, 8)],
                 events_by_epoch=[[ev(4, 3, "fail")], [],
                                  [ev(6, 1, "fail")], []])
    em = emulate({4: [RS.FailureEvent(4, 3, "fail")],
                  6: [RS.FailureEvent(6, 1, "fail")]}, kind=kind,
                 n_epochs=8, parity_groups=groups)
    epochs = [2, 3, 4, 5, 6]
    paths = [MIXED_PATHS[i % len(MIXED_PATHS)] for i in range(len(KEYS))]
    got = s.query_flows(KEYS, paths, epochs, merge="fragment",
                        failures=failures)
    assert s.fleet.has_device_window(epochs)
    np.testing.assert_allclose(got, em.query(KEYS, paths, epochs, failures),
                               rtol=1e-6)
    multi = [(p, i) for p, i in path_groups(paths).items() if len(p) > 1]
    dev = s.fleet.window_query_groups(epochs, KEYS, multi,
                                      failures=failures)
    s.records[0][0], s.records[4][0]          # the windows' host copies
    assert not s.fleet.has_device_window(epochs)
    host = s.fleet.window_query_groups(epochs, KEYS, multi,
                                       failures=failures)
    np.testing.assert_allclose(host, dev, rtol=1e-9)
    assert np.count_nonzero(dev) == sum(len(i) for _, i in multi)


def test_unobservable_window_raises():
    """A path whose only fragment is out in every epoch raises on both
    planes under "mask"; "oblivious" answers (zeros)."""
    s = port()
    run_window(s, {0: [ev(0, 3, "fail")]})
    paths = [(3,)] * len(KEYS)
    with pytest.raises(ValueError, match="unobservable"):
        s.query_flows(KEYS, paths, EPOCHS, merge="fragment")
    assert not s.query_flows(KEYS, paths, EPOCHS, merge="fragment",
                             failures="oblivious").any()
    with pytest.raises(ValueError, match="unobservable"):
        s.query_flows(KEYS, paths, EPOCHS)              # record plane
    loop = port(backend="loop")
    for e in EPOCHS:
        loop.run_epoch(e, streams_for(e, 100 + e),
                       events=[ev(0, 3, "fail")] if e == 0 else None)
    with pytest.raises(ValueError, match="unobservable"):
        loop.query_flows(KEYS, paths, EPOCHS)
    with pytest.raises(ValueError, match="policy"):
        s.query_flows(KEYS, paths, EPOCHS, failures="sometimes")


def test_oblivious_zeros_poison_min_merge():
    """Oblivious to the failure, the victim's zeroed rows drive the
    Count-Min min to 0 wherever it is out: below the masked estimate, and
    equal to the reference's emulation under both policies."""
    s = port()
    run_window(s, {2: [ev(2, 3, "fail")]})
    em = emulate({2: [RS.FailureEvent(2, 3, "fail")]})
    paths = [(2, 3)] * len(KEYS)
    obl = s.query_flows(KEYS, paths, EPOCHS, merge="fragment",
                        failures="oblivious")
    msk = s.query_flows(KEYS, paths, EPOCHS, merge="fragment")
    assert obl.sum() < msk.sum() and not obl.any()
    np.testing.assert_allclose(obl, em.query(KEYS, paths, EPOCHS,
                                             "oblivious"), atol=1e-9)
    np.testing.assert_allclose(msk, em.query(KEYS, paths, EPOCHS, "mask"),
                               rtol=1e-6)


def test_univmon_mask_on_both_planes():
    """UnivMon under churn: the all-levels device query and the per-level
    host query agree under "mask" (scaled alike), the device estimates
    equal the reference's per-level ``query_window`` on the emulation's
    valid records times the scale, and the record plane's entropy equals
    the reference's ``um_entropy_window`` on them (masked, not scaled)."""
    kw = dict(n_levels=4)
    # switch 3 is dead in epoch 0 only; switch 1 dies at offset 2, so its
    # epochs 0 and 1 are lost: epoch 0 is blind on the path (1, 3)
    events = {0: [ev(0, 3, "fail")], 1: [ev(1, 3, "recover")],
              2: [ev(2, 1, "fail")]}
    s = DiSketchSystem(MEMS, "um", rho_target=5.0, log2_te=LOG2_TE,
                       device="cpu", n_levels=4,
                       fleet_kwargs={"parity_groups": [[0, 1, 2],
                                                       [3, 4, 5]]})
    run_window(s, events)
    em = emulate({e: [RS.FailureEvent(x.epoch, x.switch, x.kind)
                      for x in v] for e, v in events.items()}, kind="um",
                 parity_groups=[[0, 1, 2], [3, 4, 5]], **kw)
    path = (1, 3)
    lvl = level_of(KEYS, 7777, 4)
    dev = s.fleet.um_level_window_query(EPOCHS, KEYS, path=path)
    scale = s.fleet.last_observability["scale"]
    recs = [[em.ctl.records[e][sw] for sw in path if em.valid(sw, e)]
            for e in EPOCHS]
    n_obs, want_scale = RQ.window_observability(recs)
    assert scale == want_scale == 4 / 3
    for l in range(4):
        m = lvl >= l
        np.testing.assert_allclose(
            dev[l, m], scale * RQ.query_window(recs, KEYS[m], "um", level=l,
                                               merge="fragment"),
            rtol=1e-6, atol=1e-6)
    s.records[0][0]                              # the host copy
    np.testing.assert_allclose(
        s.fleet.um_level_window_query(EPOCHS, KEYS, path=path), dev,
        rtol=1e-6, atol=1e-6)
    total = 4 * SW * 200.0
    got = s.query_entropy(KEYS, [path] * len(KEYS), EPOCHS, total,
                          n_levels=4)
    want = RQ.um_entropy_window([recs], [KEYS], 4, 7777, total)
    assert got == pytest.approx(want, rel=1e-9)


WINDOW_CASES = {"cs": ("cs", {}), "cms": ("cms", {}),
                "um4": ("um", dict(n_levels=4))}


@pytest.fixture(scope="module")
def fat_tree():
    kw = dict(n_flows=3000, total_packets=40_000, n_epochs=8, log2_te=12,
              burstiness=0.2, seed=1)
    wl = r_gen_workload(RFatTree(4), **kw)
    mems = {sw: 6 * 1024 for sw in range(20)}
    mems.update({sw: 12 * 1024 for sw in range(0, 20, 3)})
    return kw, wl, RS.Replayer(wl, 20), mems


def _fat_tree_schedule(mod):
    return mod.ComposedSchedule([
        mod.FailureSchedule.random(20, 0.25, down_epoch=5, up_epoch=7,
                                   seed=3),
        mod.ResourcePressure(20, horizon=8, seed=5)])


@pytest.mark.parametrize("name", sorted(WINDOW_CASES))
def test_window_churn_replay_matches_reference_emulation(fat_tree, name):
    """The slice end to end: ``Replayer.run(system, window=4, failures=
    ...)`` on a Fat-Tree with deaths inside a window, a recovery and
    resource pressure, parity groups of 5, against the emulation from the
    reference's parts: ``n_log``, ``_dead_at``, the lost cells and what
    parity can rebuild; "oblivious", "mask" and "recover" estimates on
    the device; then the record plane's counters (bit-identical) and its
    subepoch-merge estimates."""
    kw, wl, rrep, mems = fat_tree
    kind, cfg_kw = WINDOW_CASES[name]
    groups = parity_groups_chunked(range(20), 5)
    rho = 2.0
    s = DiSketchSystem(mems, kind, rho_target=rho, log2_te=12, device="cpu",
                       fleet_kwargs={"parity_groups": groups}, **cfg_kw)
    trep = TS.Replayer(gen_workload(FatTree(4), **kw), 20)
    trep.run(s, window=4, failures=_fat_tree_schedule(TS))
    em = ChurnWindowEmulation.replay(rrep.epoch_stream, mems, kind, rho, 12,
                                     8, 4, _fat_tree_schedule(RS),
                                     parity_groups=groups, **cfg_kw)
    fleet = s.fleet
    epochs = list(range(8))
    assert s.n_log == em.ctl.n_log and s.ns == em.ctl.ns
    assert s._dead_at == em.ctl._dead_at and len(s._dead_at) == 2
    assert {e: {fleet.frag_order[i] for i in v}
            for e, v in fleet._lost.items() if v} == em.lost
    assert fleet.recoverable() == em.recoverable()
    assert s.clamp_log == em.ctl.clamp_log
    sel = wl.path_len == 5
    keys, paths = wl.keys[sel], [p for p, x in zip(wl.paths, sel) if x]
    assert fleet.has_device_window(epochs)
    for failures in ("oblivious", "mask", "recover"):
        got = s.query_flows(keys, paths, epochs, merge="fragment",
                            failures=failures)
        want = em.query(keys, paths, epochs, failures)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert fleet.has_device_window(epochs)   # recovered in place
    assert_records_equal(s.records, em.ctl.records, epochs)
    np.testing.assert_allclose(
        s.query_flows(keys, paths, epochs),
        em.query(keys, paths, epochs, "mask", merge="subepoch"),
        rtol=1e-6, atol=1e-6)
    assert n_log_digest(s.n_log) == n_log_digest(em.ctl.n_log)


def test_per_epoch_replay_with_failures_matches_reference(fat_tree):
    """``Replayer.run(system, failures=...)`` per epoch on the port's
    fleet against the reference's loop backend with the same schedule:
    ``n_log``, ``_dead_at`` and the masked and oblivious estimates; the
    replay evicts the packed epochs churn reprocessed."""
    kw, wl, rrep, mems = fat_tree
    s = DiSketchSystem(mems, "cs", rho_target=2.0, log2_te=12, device="cpu")
    trep = TS.Replayer(gen_workload(FatTree(4), **kw), 20)
    for e in range(8):
        trep.epoch_packet(e, s.fleet.frag_order)
    assert trep.invalidate_packets([0]) == 1
    trep.run(s, failures=_fat_tree_schedule(TS))
    want = RSystem(mems, "cs", rho_target=2.0, log2_te=12)
    rrep.run(want, failures=_fat_tree_schedule(RS))
    assert s.n_log == want.n_log and s._dead_at == want._dead_at
    assert_records_equal(s.records, want.records, range(8))
    sel = wl.path_len == 5
    keys, paths = wl.keys[sel], [p for p, x in zip(wl.paths, sel) if x]
    for failures in ("mask", "oblivious"):
        np.testing.assert_allclose(
            s.query_flows(keys, paths, range(4, 8), failures=failures),
            want.query_flows(keys, paths, range(4, 8), failures=failures),
            rtol=1e-6, atol=1e-6)
