"""The port's versioned control plane (``repro_torch.runtime.control``)
against the JAX package's (``repro.runtime.control``).

Two groups of tests:

* the reference's own suite (``tests/test_control.py``) carried over to the
  port at the same fixture: 4 switches, cms, rho 0.05, 6 epochs, log2_te
  10, windows of 2 on the fleet backend.  Loss-free, the plane is
  bit-identical to the oracle loop; lossy, configs go stale but every
  counter equals a twin pinned to the applied configs;
* parity with the reference's plane around its **loop** backend (its
  fleet backend does not run on a CPU: its Pallas calls fail under jax
  0.9).  That plane is an exact oracle per epoch, with or without churn,
  and for a window with no event inside it when ``run_window`` is called
  on it directly: its loop fallback runs the window's epochs with ``ns``
  unchanged (external control), and ``_post_dispatch`` walks the window's
  PEBs once, which is the fleet window's semantics.  (Its
  ``Replayer.run`` runs a system without a fleet epoch by epoch whatever
  the window, so the parity tests do not go through it for windows.)

The parity tests compare the applied and intent logs, the stale epochs,
the clamp log, the version lag, ``stats()``, every agent and sketch
counter exactly, and ``query_flows`` to 1e-6 relative.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.disketch import DiSketchSystem as RSystem
from repro.core.disketch import SwitchStream as RStream
from repro.net import simulator as RS
from repro.net.channel import LossyChannel as RChannel
from repro.net.topology import FatTree as RFatTree
from repro.net.traffic import gen_workload as r_gen_workload
from repro.runtime.control import VersionedControlPlane as RPlane
from repro_torch.core import equalize
from repro_torch.core.disketch import DiscoSystem, DiSketchSystem, SwitchStream
from repro_torch.net import simulator as TS
from repro_torch.net.channel import LossyChannel
from repro_torch.net.topology import FatTree
from repro_torch.net.traffic import gen_workload
from repro_torch.runtime import (ConfigAck, ConfigDirective,
                                 SwitchConfigAgent, VersionedControlPlane)
from repro_torch.runtime.control import _pow2_clamp
from torch_threads import one_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
from reference_pins import ChurnWindowEmulation  # noqa: E402

SW = 4
LOG2_TE = 10
MEMS = {sw: 256 for sw in range(SW)}
RHO = 0.05                  # a tight target keeps the Eq. 6 loop active
N_EPOCHS = 6
KEYS = np.arange(40).astype(np.uint32)
PATHS = [tuple(range(SW))] * len(KEYS)
EPOCHS = list(range(N_EPOCHS))


def streams_for(epoch, seed, cls=SwitchStream, n_pkts=200, n_keys=40):
    r = np.random.default_rng(seed)
    out = {}
    for sw in range(SW):
        keys = r.integers(0, n_keys, n_pkts).astype(np.uint32)
        ts = ((epoch << LOG2_TE)
              + np.sort(r.integers(0, 1 << LOG2_TE, n_pkts)).astype(
                  np.int64))
        out[sw] = cls(keys, np.ones(n_pkts, np.int64), ts)
    return out


STREAMS = [streams_for(e, 300 + e) for e in range(N_EPOCHS)]
R_STREAMS = [streams_for(e, 300 + e, RStream) for e in range(N_EPOCHS)]


# the sketch kinds of the parity cases: UnivMon with 4 levels
KINDS = {"cms": ("cms", {}), "cs": ("cs", {}), "um4": ("um", {"n_levels": 4})}


def build(backend="loop", kind="cms"):
    kind, kw = KINDS[kind]
    if backend == "fleet":
        kw = dict(kw, device="cpu")
    return DiSketchSystem(MEMS, kind, rho_target=RHO, log2_te=LOG2_TE,
                          backend=backend, **kw)


def run_all(target, backend, events_at=None):
    events_at = events_at or {}
    if backend == "fleet":
        for e0 in range(0, N_EPOCHS, 2):
            evs = [events_at.get(e0), events_at.get(e0 + 1)]
            target.run_window(e0, STREAMS[e0:e0 + 2],
                              events_by_epoch=(evs if any(evs) else None))
    else:
        for e in range(N_EPOCHS):
            target.run_epoch(e, STREAMS[e], events=events_at.get(e))


def cells(system, backend):
    if backend == "fleet":
        fl = system.fleet
        out = {}
        for e in EPOCHS:
            live = fl.frag_live(e)
            for i, sw in enumerate(fl.frag_order):
                if live is None or live[i]:
                    out[(sw, e)] = np.asarray(fl.cell_counters(e, sw))
        return out
    return {(sw, e): np.asarray(rec.counters)
            for e in EPOCHS for sw, rec in system.records[e].items()}


def lossy_ctrl(seed=9, p_drop=0.4, cls=LossyChannel):
    return (cls(p_drop=p_drop, p_dup=0.2, p_reorder=0.3, delay=(0, 1),
                seed=seed),
            cls(p_drop=0.5 * p_drop, p_dup=0.2, delay=(0, 1), seed=seed + 1))


# -- the reference's suite, on the port ---------------------------------------

def test_pow2_clamp_exact():
    assert _pow2_clamp(0.0) == 1
    assert _pow2_clamp(1.0) == 1
    assert _pow2_clamp(3.0) == 4          # round(log2 3) = 2
    assert _pow2_clamp(6.0) == 8
    assert _pow2_clamp(32.0) == 32
    assert _pow2_clamp(float("inf")) == 1
    assert _pow2_clamp(float("nan")) == 1
    assert _pow2_clamp(1e12) == equalize.N_MAX


def test_agent_highest_version_wins_and_reacks():
    a = SwitchConfigAgent(0, n0=1, width0=64)
    ack2 = a.on_directive(ConfigDirective(0, 2, 8, 64, 0.1), 64)
    assert (a.version, a.n) == (2, 8) and ack2.n_applied == 8
    # a stale reorder (v1) and a duplicate (v2) are no-ops but re-ACK
    ack1 = a.on_directive(ConfigDirective(0, 1, 2, 64, 0.1), 64)
    ackd = a.on_directive(ConfigDirective(0, 2, 8, 64, 0.1), 64)
    assert (a.version, a.n) == (2, 8)
    assert a.n_stale_dropped == 2 and a.n_applied_directives == 1
    # every (re-)ACK carries a fresh monotone seq (a fresh channel fate)
    assert ack2.seq < ack1.seq < ackd.seq


def test_agent_clamps_against_actual_width():
    a = SwitchConfigAgent(0, n0=1, width0=256)
    # computed for width 256, the switch shrank to 64: Eq. 4 goes as
    # ~1/width, so n is rescaled by 256/64 = 4x, rounded to a power of 2
    ack = a.on_directive(ConfigDirective(0, 1, 8, 256, 0.1), 64)
    assert a.n == _pow2_clamp(8 * 256 / 64) == 32
    assert a.n_clamped == 1
    # the applied config assumed width 256 but the switch has 64: NACK
    assert ack.clamped and ack.width == 64
    # a corrective directive with the true width stops the beacon
    ack = a.on_directive(ConfigDirective(0, 2, 32, 64, 0.1), 64)
    assert not ack.clamped and a.assumed_width == 64


def test_agent_local_sync_adopts_out_of_band_state():
    a = SwitchConfigAgent(0, n0=8, width0=256)
    a.local_sync(1, 64)                   # a recover restarted at n_0 = 1
    assert a.n == 1 and a.assumed_width == 64
    assert not a.ack(64).clamped


def test_plane_rejects_non_subepoching_system():
    disco = DiscoSystem(MEMS, "cms", rho_target=RHO, log2_te=LOG2_TE,
                        device="cpu")
    with pytest.raises(ValueError, match="subepoching"):
        VersionedControlPlane(disco)


def test_plane_validation():
    with pytest.raises(ValueError):
        VersionedControlPlane(build(), max_retries=-1)
    with pytest.raises(ValueError):
        VersionedControlPlane(build(), backoff0=4, backoff_max=2)


@pytest.mark.parametrize("backend", ["loop", "fleet"])
def test_lossfree_plane_bit_identical_to_oracle(backend):
    oracle = build(backend)
    run_all(oracle, backend)
    plane = VersionedControlPlane(build(backend))
    run_all(plane, backend)
    assert plane.n_directives > 0         # the loop engaged
    assert plane.stale_epochs() == []     # ...and never ran stale
    want, got = cells(oracle, backend), cells(plane.system, backend)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    merge = "fragment" if backend == "fleet" else "subepoch"
    assert np.array_equal(
        plane.query_flows(KEYS, PATHS, EPOCHS, merge=merge),
        oracle.query_flows(KEYS, PATHS, EPOCHS, merge=merge))
    # the as-run configs are the oracle's n trajectory one dispatch later
    # (applied_log[d] is what dispatch d ran; the oracle's n_log[e] is the
    # n after epoch e, the last of a window's epochs for the next window)
    per = 1 if backend == "loop" else 2
    for d in range(1, N_EPOCHS // per):
        assert plane.applied_log[d] == oracle.n_log[per * d - 1]


def _twin_from_applied(plane, backend):
    twin = build(backend)
    twin.control_external = True
    for d in range(N_EPOCHS if backend == "loop" else N_EPOCHS // 2):
        twin.ns.update(plane.applied_log[d])
        if backend == "fleet":
            twin.run_window(2 * d, STREAMS[2 * d:2 * d + 2])
        else:
            twin.run_epoch(d, STREAMS[d])
    return twin


@pytest.mark.parametrize("backend", ["loop", "fleet"])
def test_lossy_control_goes_stale_but_counters_match_applied_twin(backend):
    plane = VersionedControlPlane(build(backend),
                                  *lossy_ctrl(seed=17, p_drop=0.6))
    run_all(plane, backend)
    assert plane.stale_epochs()           # loss made configs run stale
    twin = _twin_from_applied(plane, backend)
    want, got = cells(twin, backend), cells(plane.system, backend)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    # staleness is stamped into observability on every query
    merge = "fragment" if backend == "fleet" else "subepoch"
    plane.query_flows(KEYS, PATHS, EPOCHS, merge=merge)
    obs = plane.last_observability
    assert obs["stale_config"] == plane.stale_epochs()
    assert obs["n_stale_config"] == len(plane.stale_epochs())
    assert set(obs["stale_config_switches"]) == set(obs["stale_config"])


def test_lossy_control_drains_to_convergence():
    plane = VersionedControlPlane(build(), *lossy_ctrl(seed=23, p_drop=0.5))
    run_all(plane, "loop")
    plane.drain()
    for sw, ent in plane.entries.items():
        assert ent.outstanding is None
        assert plane.agents[sw].n == ent.directed_n == ent.acked_n
    assert max(plane.version_lag().values()) == 0
    s = plane.stats()
    assert s["n_outstanding"] == 0 and s["channel"]["n_dropped"] > 0


def test_stale_reordered_ack_is_dropped():
    plane = VersionedControlPlane(build())
    ent = plane.entries[0]
    ent.version = ent.acked_seq = 0
    fresh = ConfigAck(0, 1, 4, 256, False, seq=5)
    stale = ConfigAck(0, 1, 2, 256, False, seq=3)
    plane._reconcile(fresh)
    assert ent.acked_n == 4 and ent.acked_seq == 5
    plane._reconcile(stale)               # reordered older state: no-op
    assert ent.acked_n == 4 and plane.n_stale_acks == 1


def test_nack_beacon_reports_unsolicited_width_change():
    plane = VersionedControlPlane(build(), nack_interval=1)
    run_all(plane, "loop")
    plane.drain()
    # resource pressure shrinks switch 2 out of band: no directive
    # commanded it, only the beacon can tell the controller
    plane.system.apply_event(TS.FailureEvent(N_EPOCHS, 2, "shrink", 0.25))
    w_actual = int(plane.system.fragments[2].width)
    assert plane.agents[2].assumed_width != w_actual
    before = plane.n_nacks_tx
    plane.drain()
    assert plane.n_nacks_tx > before      # the beacon fired
    # reconciliation adopted the true width and converged n again; the
    # corrective directive carried it and stopped the beacon
    assert plane.entries[2].believed_width == w_actual
    assert plane.agents[2].assumed_width == w_actual
    assert plane.agents[2].n == plane.entries[2].directed_n


def test_exhausted_directive_reissued_next_dispatch():
    # a black-hole channel: every directive version spends its retry
    # budget, but staleness stays bounded (each dispatch re-issues under a
    # fresh version), and once the channel heals the fleet converges
    plane = VersionedControlPlane(build(),
                                  LossyChannel(p_drop=1.0, seed=3),
                                  max_retries=2)
    run_all(plane, "loop")
    assert plane.stale_epochs()           # nothing ever arrived
    v_first = max(e.version for e in plane.entries.values())
    assert v_first > 1                    # re-issue kept the loop alive
    assert all(a.n_applied_directives == 0 for a in plane.agents.values())
    plane.channel = LossyChannel()        # the channel heals
    # a dispatch boundary re-issues the spent directives
    plane._post_dispatch(0, {sw: a.n for sw, a in plane.agents.items()})
    plane.drain()
    for sw, ent in plane.entries.items():
        assert plane.agents[sw].n == ent.directed_n


def test_recover_syncs_agent_and_controller():
    plane = VersionedControlPlane(build())
    run_all(plane, "loop",
            events_at={2: [TS.FailureEvent(2, 1, "fail")],
                       4: [TS.FailureEvent(4, 1, "recover")]})
    plane.drain()
    # the rejoin rides the boot path: the agent holds the restart config
    # (evolved by control since), the controller agrees, nothing diverges
    assert 1 not in plane.system.dead
    assert plane.agents[1].n == plane.entries[1].directed_n
    assert plane.applied_log[4][1] == 1   # restarted at n_0 = 1
    # while dead, switch 1 is never counted stale
    for e in plane.stale_epochs():
        if 2 <= e < 4:
            assert 1 not in plane._epoch_stale[e]


# -- parity with the reference's loop-backend plane ---------------------------

def ref_build(kind="cms"):
    kind, kw = KINDS[kind]
    return RSystem(MEMS, kind, rho_target=RHO, log2_te=LOG2_TE, **kw)


def schedule(mod):
    """Switch 1 dies at epoch 2 and returns at 4, beside seeded resource
    pressure that shrinks and regrows switches 0, 2 and 3."""
    return mod.ComposedSchedule([
        mod.FailureSchedule(SW, downs={1: (2, 4)}),
        mod.ResourcePressure(SW, horizon=N_EPOCHS, seed=5, p_grab=0.5)])


def channels(lossy, cls):
    return lossy_ctrl(seed=17, p_drop=0.4, cls=cls) if lossy else ()


def assert_plane_parity(got, want, epochs=EPOCHS):
    """Every log, counter and stamp of the two planes, and the sketch
    counters of every record, exactly."""
    assert got.applied_log == want.applied_log
    assert got.intent_log == want.intent_log
    assert got.stale_epochs() == want.stale_epochs()
    assert got._epoch_stale == want._epoch_stale
    assert got.clamp_log == want.clamp_log
    assert got.version_lag() == want.version_lag()
    assert got.stats() == want.stats()
    assert got.now == want.now
    for sw, a in want.agents.items():
        b = got.agents[sw]
        assert (b.version, b.n, b.assumed_width, b._ack_seq,
                b.n_applied_directives, b.n_stale_dropped, b.n_clamped) == \
            (a.version, a.n, a.assumed_width, a._ack_seq,
             a.n_applied_directives, a.n_stale_dropped, a.n_clamped), sw
        ge, we = got.entries[sw], want.entries[sw]
        assert (ge.version, ge.directed_n, ge.believed_width,
                ge.acked_version, ge.acked_n, ge.acked_seq, ge.attempts,
                ge.next_send) == \
            (we.version, we.directed_n, we.believed_width, we.acked_version,
             we.acked_n, we.acked_seq, we.attempts, we.next_send), sw
        assert (ge.outstanding is None) == (we.outstanding is None), sw
        if we.outstanding is not None:
            assert ge.outstanding.__dict__ == we.outstanding.__dict__
    s, r = got.system, want.system
    assert s.n_log == r.n_log and s.ns == r.ns
    assert s._dead_at == r._dead_at and s.clamp_log == r.clamp_log
    assert {sw: c.width for sw, c in s.fragments.items()} == \
        {sw: c.width for sw, c in r.fragments.items()}
    for e in epochs:
        assert sorted(s.records[e]) == sorted(r.records[e]), e
        for sw, rec in r.records[e].items():
            assert s.records[e][sw].n == rec.n, (e, sw)
            np.testing.assert_array_equal(s.records[e][sw].counters,
                                          rec.counters)


def assert_query_parity(got, want, merge, epochs=EPOCHS):
    np.testing.assert_allclose(
        got.query_flows(KEYS, PATHS, epochs, merge=merge),
        want.query_flows(KEYS, PATHS, epochs, merge=merge),
        rtol=1e-6, atol=1e-6)
    for k in ("stale_config", "n_stale_config", "stale_config_switches",
              "config_version_lag", "config_clamps", "per_epoch",
              "observable_cells"):
        assert got.last_observability[k] == want.last_observability[k], k


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("churn", [False, True], ids=["steady", "churn"])
@pytest.mark.parametrize("lossy", [False, True], ids=["lossless", "lossy"])
@pytest.mark.parametrize("backend", ["fleet", "loop"])
def test_per_epoch_plane_matches_reference(backend, lossy, churn, kind):
    got = VersionedControlPlane(build(backend, kind),
                                *channels(lossy, LossyChannel))
    want = RPlane(ref_build(kind), *channels(lossy, RChannel))
    t_sched, r_sched = (schedule(TS), schedule(RS)) if churn else (None,
                                                                    None)
    for e in EPOCHS:
        got.run_epoch(e, STREAMS[e],
                      events=t_sched.advance(e) if churn else None)
        want.run_epoch(e, R_STREAMS[e],
                       events=r_sched.advance(e) if churn else None)
    if churn:
        assert t_sched.log and any(ev.kind == "shrink" for ev in t_sched.log)
        assert got.n_nacks_tx > 0         # the pressure reached the agents
    assert_plane_parity(got, want)
    for merge in ("subepoch", "fragment"):
        assert_query_parity(got, want, merge)
    assert got.drain() == want.drain()
    assert_plane_parity(got, want)
    assert set(got.version_lag().values()) == {0}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("lossy", [False, True], ids=["lossless", "lossy"])
def test_window_plane_matches_reference(lossy, kind):
    """Windows of 2 on the port's fleet against the reference's loop plane
    with ``run_window`` called on it directly (no event in a window)."""
    got = VersionedControlPlane(build("fleet", kind),
                                *channels(lossy, LossyChannel))
    want = RPlane(ref_build(kind), *channels(lossy, RChannel))
    for e0 in range(0, N_EPOCHS, 2):
        got.run_window(e0, STREAMS[e0:e0 + 2])
        want.run_window(e0, R_STREAMS[e0:e0 + 2])
    assert len(got.applied_log) == N_EPOCHS // 2
    assert bool(got.stale_epochs()) == lossy
    assert_query_parity(got, want, "fragment")   # the device plane
    assert got.fleet.has_device_window(EPOCHS)
    assert_plane_parity(got, want)               # copies to the host
    assert_query_parity(got, want, "subepoch")
    assert got.drain() == want.drain()
    assert_plane_parity(got, want)


@pytest.mark.parametrize("window", [3, 4])
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("lossy", [False, True], ids=["lossless", "lossy"])
def test_window_plane_with_churn_inside_windows_matches_emulation(
        lossy, kind, window):
    """Windows of 3 and 4 on the port's fleet under ``schedule``: switch 1
    dies at epoch 2, inside the first window, which loses its earlier
    epochs there; resource pressure falls on any epoch, its resizes wait
    for the next dispatch.  The oracle is the reference's plane around
    ``ChurnWindowEmulation``, the reference's fleet window path rebuilt
    from its parts, each window handed the agents' applied configs by the
    plane (``_frozen_ns``)."""
    got = VersionedControlPlane(build("fleet", kind),
                                *channels(lossy, LossyChannel))
    name, kw = KINDS[kind]
    em = ChurnWindowEmulation(MEMS, name, RHO, LOG2_TE, **kw)
    want = RPlane(em, *channels(lossy, RChannel))
    t_sched, r_sched = schedule(TS), schedule(RS)
    for e0 in range(0, N_EPOCHS, window):
        es = range(e0, min(e0 + window, N_EPOCHS))
        got.run_window(e0, STREAMS[e0:e0 + window],
                       events_by_epoch=[t_sched.advance(e) for e in es])
        want.run_window(e0, R_STREAMS[e0:e0 + window],
                        events_by_epoch=[r_sched.advance(e) for e in es])
        assert em.ns_by_window[e0] == want.applied_log[-1]
    assert any(ev.epoch % window for ev in t_sched.log)
    assert {e: {got.system.fleet.frag_order[i] for i in v}
            for e, v in got.system.fleet._lost.items() if v} == em.lost \
        == {0: {1}, 1: {1}}
    assert got.n_nacks_tx > 0           # the pressure reached the agents
    for merge in ("fragment", "subepoch"):
        assert_query_parity(got, want, merge)
    assert_plane_parity(got, want)
    assert got.drain() == want.drain()
    assert_plane_parity(got, want)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("lossy", [False, True], ids=["lossless", "lossy"])
def test_per_epoch_plane_under_churn_matches_emulation(lossy, kind):
    """Per epoch on the port's fleet under ``schedule``, against the
    reference's plane around ``ChurnWindowEmulation.run_epoch`` (a window
    of one whose dead switches keep no record, as the fleet's per-epoch
    path keeps none)."""
    got = VersionedControlPlane(build("fleet", kind),
                                *channels(lossy, LossyChannel))
    name, kw = KINDS[kind]
    want = RPlane(ChurnWindowEmulation(MEMS, name, RHO, LOG2_TE, **kw),
                  *channels(lossy, RChannel))
    t_sched, r_sched = schedule(TS), schedule(RS)
    for e in EPOCHS:
        got.run_epoch(e, STREAMS[e], events=t_sched.advance(e))
        want.run_epoch(e, R_STREAMS[e], events=r_sched.advance(e))
    assert got.system._dead_at and got.n_nacks_tx > 0
    assert_plane_parity(got, want)
    for merge in ("subepoch", "fragment"):
        assert_query_parity(got, want, merge)


def test_control_external_off_by_default_keeps_the_oracle():
    """Without a plane nothing changes: the flag is off, Eq. 6 and the §6
    re-equalization run inside the system, as in the reference."""
    got, want = build("fleet"), ref_build()
    assert got.control_external is False and build().control_external \
        is False
    t_sched, r_sched = schedule(TS), schedule(RS)
    for e in EPOCHS:
        got.run_epoch(e, STREAMS[e], events=t_sched.advance(e))
        want.run_epoch(e, R_STREAMS[e], events=r_sched.advance(e))
    assert got.n_log == want.n_log and got.clamp_log == want.clamp_log
    assert len(set(map(frozenset, (d.items() for d in got.n_log)))) > 1
    # the same system under a plane runs the applied configs instead
    plane = VersionedControlPlane(build("fleet"))
    assert plane.system.control_external is True


# -- the slice end to end: Replayer.run on a Fat-Tree -------------------------

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


@pytest.mark.parametrize("mode", ["window", "epoch-churn"])
def test_replayer_drives_the_plane_like_the_reference(fat_tree, mode):
    """``Replayer.run(plane, ...)`` composes unchanged: windows of 4 on the
    fleet against the reference's loop plane run window by window, and
    per-epoch churn against its ``Replayer.run``, lossy channels."""
    kw, wl, rrep, mems = fat_tree
    got = VersionedControlPlane(
        DiSketchSystem(mems, "cs", rho_target=2.0, log2_te=12, device="cpu"),
        *lossy_ctrl(seed=17, p_drop=0.4))
    want = RPlane(RSystem(mems, "cs", rho_target=2.0, log2_te=12),
                  *lossy_ctrl(seed=17, p_drop=0.4, cls=RChannel))
    trep = TS.Replayer(gen_workload(FatTree(4), **kw), 20)
    sel = wl.path_len == 5
    keys, paths = wl.keys[sel], [p for p, x in zip(wl.paths, sel) if x]
    if mode == "window":
        trep.run(got, window=4)
        for e0 in (0, 4):
            want.run_window(e0, [rrep.epoch_stream(e)
                                 for e in range(e0, e0 + 4)])
        merge, epochs = "fragment", list(range(8))
    else:
        trep.run(got, failures=_fat_tree_schedule(TS))
        rrep.run(want, failures=_fat_tree_schedule(RS))
        assert got.system._dead_at and got.stats()["n_nacks_tx"] > 0
        merge, epochs = "subepoch", list(range(4, 8))
    assert got.stale_epochs()
    np.testing.assert_allclose(
        got.query_flows(keys, paths, epochs, merge=merge),
        want.query_flows(keys, paths, epochs, merge=merge),
        rtol=1e-6, atol=1e-6)
    assert got.last_observability["stale_config"] == \
        want.last_observability["stale_config"]
    assert_plane_parity(got, want, epochs=range(8))
