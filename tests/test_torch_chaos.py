"""The port's chaos harness (``repro_torch.runtime.chaos``) against the JAX
package's (``repro.runtime.chaos``).

Three groups of tests:

* the reference's own suite (``tests/test_chaos.py``) carried over to the
  port at the same fixture: FatTree(4), 400 flows, 6 epochs, cms, rho
  0.05, the versioned control plane over the durable export plane over
  the loop backend (per epoch) or the fleet (windows of 2, ``device=
  "cpu"`` where the reference passes ``interpret=True``).  Loss-free, the
  composed stack is bit-identical to a bare system; under churn, export
  loss, collector crashes, control loss and resource pressure every
  invariant holds and the applied-config twin reproduces every applied
  cell.  The seed and loss sweep is ``chaos`` and ``slow`` marked;
* three cross-package oracles, for cs and cms.  Each compares the
  ``finish()`` report, the crash log, the staged, applied and lost sets,
  the control plane's applied, intent, clamp and stale logs, the
  system's ``n_log``, dead epochs and clamps exactly, every applied cell
  bit for bit (the fleet's live block against the reference's record),
  and the ``failures="mask"`` query within 1e-6 with its observability:

  (a) the port's loop backend per epoch against the reference's harness
      around its loop backend, both through their ``Replayer.run``;
  (b) the port's fleet in windows of 2, with events only at window
      starts, against the reference's harness around its loop backend,
      driven window by window through ``run_window`` (its
      ``Replayer.run`` dispatches a fleet-less system once an epoch, and
      the harness counts dispatches for its crashes and stale ledger).
      Under the control plane ``ns`` is frozen for the window on both;
  (c) the port's fleet with events *inside* windows (a death at window
      offset 1, resource pressure on any epoch) against the reference's
      harness and planes around ``scripts/reference_pins.py::
      ChurnWindowEmulation(export=True)``, the reference's fleet window
      path rebuilt from its numpy parts (its fleet backend cannot run on
      a CPU: its Pallas calls fail under jax 0.9).  Its dead and lost
      cells are kept out of ``records``, so the reference's export plane
      stages the live cells only, as the port's fleet does;
* a fault the harness must catch: a tampered applied cell, a staged cell
  dropped from the collector's books, a forged stale-ledger entry.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.disketch import DiSketchSystem as RSystem
from repro.net import simulator as RS
from repro.net.channel import LossyChannel as RChannel
from repro.net.topology import FatTree as RFatTree
from repro.net.traffic import gen_workload as r_gen_workload
from repro.runtime.chaos import ChaosHarness as RHarness
from repro.runtime.control import VersionedControlPlane as RControl
from repro.runtime.export import DurableExportPlane as RExport
from repro_torch.core.disketch import DiSketchSystem
from repro_torch.net import simulator as TS
from repro_torch.net.channel import LossyChannel
from repro_torch.net.topology import FatTree
from repro_torch.net.traffic import gen_workload
from repro_torch.runtime import (ChaosHarness, ChaosInvariantError,
                                 DurableExportPlane, VersionedControlPlane,
                                 cells_equal)
from repro_torch.runtime.chaos import _cell

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
from reference_pins import ChurnWindowEmulation  # noqa: E402

N_SW = 20
N_EPOCHS = 6
WL_KW = dict(n_flows=400, total_packets=6_000, n_epochs=N_EPOCHS,
             burstiness=0.2, seed=13)
WL = gen_workload(FatTree(4), **WL_KW)
R_WL = r_gen_workload(RFatTree(4), **WL_KW)
MEMS = {sw: 256 for sw in range(N_SW)}
RHO = 0.05
EPOCHS = list(range(N_EPOCHS))
KEYS = WL.keys[:30]
PATHS = [WL.paths[i] for i in range(30)]


def build(backend, kind="cms"):
    kw = dict(device="cpu") if backend == "fleet" else {}
    return DiSketchSystem(MEMS, kind, rho_target=RHO, log2_te=WL.log2_te,
                          backend=backend, **kw)


def channels(mod, p_export, p_ctrl, seed):
    """The reference tests' channels: p == 0 composes lossless (and
    jitter-free) channels."""
    exp_ch = (mod(p_drop=p_export, p_dup=0.1, p_reorder=0.2, delay=(0, 2),
                  seed=seed),
              mod(p_drop=0.5 * p_export, p_dup=0.1, delay=(0, 1),
                  seed=seed + 1)) if p_export else (None, None)
    ctl_ch = (mod(p_drop=p_ctrl, p_dup=0.1, p_reorder=0.3, delay=(0, 1),
                  seed=seed + 2),
              mod(p_drop=0.5 * p_ctrl, p_dup=0.1, delay=(0, 1),
                  seed=seed + 3)) if p_ctrl else (None, None)
    return exp_ch, ctl_ch


def compose(system, p_export=0.0, p_ctrl=0.0, seed=40, mods=(
        DurableExportPlane, VersionedControlPlane, LossyChannel)):
    export_cls, control_cls, channel_cls = mods
    exp_ch, ctl_ch = channels(channel_cls, p_export, p_ctrl, seed)
    export = export_cls(system, *exp_ch, max_retries=12,
                        steps_per_dispatch=0)
    return control_cls(export, *ctl_ch)


REF = (RExport, RControl, RChannel)


def query(target, backend):
    merge = "fragment" if backend == "fleet" else "subepoch"
    return np.asarray(target.query_flows(KEYS, PATHS, EPOCHS, merge=merge,
                                         failures="mask"))


def chaos_schedule(mod, seed=21):
    churn = mod.FailureSchedule(N_SW, downs={3: (2, 4), 9: (3, None)})
    pressure = mod.ResourcePressure(N_SW, horizon=N_EPOCHS, seed=seed,
                                    p_grab=0.3)
    return mod.ComposedSchedule([churn, pressure])


def window_start_schedule(mod):
    """Deaths, a recovery and resizes at epochs 0, 2 and 4 only: the
    window starts of windows of 2."""
    return mod.FailureSchedule(
        N_SW, downs={3: (2, 4), 9: (4, None)},
        shrinks=[(0, 7, 0.6), (2, 5, 0.5), (2, 11, 0.4), (4, 5, 2.0),
                 (4, 0, 0.7)])


# -- the reference's suite, on the port ---------------------------------------

def test_harness_requires_snapshotable_export():
    plane = DurableExportPlane(build("loop"), steps_per_dispatch=2)
    with pytest.raises(ValueError, match="steps_per_dispatch=0"):
        ChaosHarness(plane)


def test_harness_crash_needs_export_plane():
    with pytest.raises(ValueError, match="export plane"):
        ChaosHarness(build("loop"), crash_every=2)


@pytest.mark.parametrize("backend", ["loop", "fleet"])
def test_lossfree_composed_stack_bit_identical_to_oracle(backend):
    win = 2 if backend == "fleet" else 1
    oracle = build(backend)
    TS.Replayer(WL, N_SW).run(oracle, window=win)
    h = ChaosHarness(compose(build(backend)), steps_per_dispatch=4)
    TS.Replayer(WL, N_SW).run(h, window=win)
    report = h.finish()
    assert not report["lost"] and not report["stale_epochs"]
    assert report["staged"] == N_SW * N_EPOCHS
    assert cells_equal(h.system, oracle, sorted(h.staged))
    assert np.array_equal(query(h, backend), query(oracle, backend))


@pytest.mark.parametrize("backend,window", [("loop", 1), ("fleet", 2)])
def test_full_chaos_invariants_and_twin(backend, window):
    h = ChaosHarness(compose(build(backend), p_export=0.2, p_ctrl=0.5,
                             seed=60),
                     steps_per_dispatch=6, crash_every=2)
    TS.Replayer(WL, N_SW).run(h, window=window,
                              failures=chaos_schedule(TS))
    report = h.finish()                   # partition + ledger checks
    assert report["crashes"] >= 1
    assert report["n_stale_epochs"] > 0   # control loss showed up...
    n_cells = h.verify_config_twin(lambda: build(backend))
    assert n_cells == report["applied"] > 0   # ...but corrupted nothing
    # staleness and clamps ride observability on every query
    assert np.isfinite(query(h, backend)).all()
    obs = h.last_observability
    assert obs["stale_config"] == h.control.stale_epochs()
    assert obs["config_clamps"] == (list(h.system.clamp_log)
                                    + list(h.control.clamp_log))


def test_harness_over_bare_export_plane_checks_partition_only():
    export = DurableExportPlane(
        build("loop"), LossyChannel(p_drop=0.3, seed=5),
        LossyChannel(seed=6), max_retries=12, steps_per_dispatch=0)
    h = ChaosHarness(export, steps_per_dispatch=6, crash_every=3)
    TS.Replayer(WL, N_SW).run(h, window=1)
    report = h.finish()
    assert h.control is None and "stale_epochs" not in report
    assert report["applied"] + len(report["lost"]) == report["staged"]


@pytest.mark.chaos
@pytest.mark.slow
def test_chaos_soak_seed_and_loss_sweep():
    """Seed x control-loss sweep with every failure plane armed: every
    invariant holds at every point, and the twin reproduces every applied
    cell bit for bit."""
    for seed in (1, 2, 3):
        for p_ctrl in (0.3, 0.6, 0.9):
            h = ChaosHarness(
                compose(build("fleet"), p_export=0.25, p_ctrl=p_ctrl,
                        seed=100 * seed),
                steps_per_dispatch=6, crash_every=2)
            TS.Replayer(WL, N_SW).run(
                h, window=2, failures=chaos_schedule(TS, seed=seed))
            report = h.finish()
            h.verify_config_twin(lambda: build("fleet"))
            assert np.isfinite(query(h, "fleet")).all(), (seed, p_ctrl)
            assert (report["applied"] + len(report["lost"])
                    == report["staged"]), (seed, p_ctrl)


# -- the cross-package oracles -------------------------------------------------

def _run_windows(h, rep, window, schedule):
    """The reference's side, window by window through ``run_window``."""
    for e0 in range(0, N_EPOCHS, window):
        es = range(e0, min(e0 + window, N_EPOCHS))
        h.run_window(e0, [rep.epoch_stream(e) for e in es],
                     events_by_epoch=[schedule.advance(e) for e in es])


def assert_harness_parity(got, want, backend):
    """The report, crash log, cell sets, control logs, system logs and
    every applied cell of the two harnesses, exactly; then the mask
    query within 1e-6 and its observability."""
    report = got.finish()
    assert report == want.finish()
    assert report["crashes"] >= 1 and report["n_stale_epochs"] > 0
    assert got.crash_log == want.crash_log
    assert got.staged == want.staged
    assert got.export.collector.applied == want.export.collector.applied
    assert got.export.lost_cells() == want.export.lost_cells()
    assert got.export.pending_cells() == want.export.pending_cells() == set()
    ctl, rctl = got.control, want.control
    assert ctl.applied_log == rctl.applied_log
    assert ctl.intent_log == rctl.intent_log
    assert ctl.clamp_log == rctl.clamp_log
    assert ctl._epoch_stale == rctl._epoch_stale
    assert ctl.stats() == rctl.stats()
    s, r = got.system, want.system
    assert s.n_log == r.n_log and s.ns == r.ns
    assert s._dead_at == r._dead_at and s.clamp_log == r.clamp_log
    applied = sorted(want.export.collector.applied)
    for sw, e in applied:
        cell = _cell(s, sw, e)
        np.testing.assert_array_equal(
            cell[0] if backend == "fleet" else cell,
            r.records[e][sw].counters, err_msg=str((sw, e)))
    merge = "fragment" if backend == "fleet" else "subepoch"
    np.testing.assert_allclose(
        got.query_flows(KEYS, PATHS, EPOCHS, merge=merge, failures="mask"),
        want.query_flows(KEYS, PATHS, EPOCHS, merge=merge, failures="mask"),
        rtol=1e-6, atol=1e-6)
    w_obs = want.last_observability
    assert {k: got.last_observability[k] for k in w_obs} == w_obs
    return applied


@pytest.mark.parametrize("kind", ["cs", "cms"])
def test_loop_harness_matches_reference_per_epoch(kind):
    """(a) Per epoch on the loop backends, through both ``Replayer.run``s."""
    got = ChaosHarness(compose(build("loop", kind), 0.2, 0.5, seed=60),
                       steps_per_dispatch=6, crash_every=2)
    want = RHarness(compose(RSystem(MEMS, kind, rho_target=RHO,
                                    log2_te=R_WL.log2_te), 0.2, 0.5,
                            seed=60, mods=REF),
                    steps_per_dispatch=6, crash_every=2)
    TS.Replayer(WL, N_SW).run(got, failures=chaos_schedule(TS))
    RS.Replayer(R_WL, N_SW).run(want, failures=chaos_schedule(RS))
    assert got.n_dispatches == N_EPOCHS
    applied = assert_harness_parity(got, want, "loop")
    assert got.verify_config_twin(lambda: build("loop", kind)) == \
        len(applied)


@pytest.mark.parametrize("kind", ["cs", "cms"])
def test_fleet_window_matches_reference_at_window_starts(kind):
    """(b) Windows of 2 on the port's fleet, every event at a window
    start, against the reference's loop backend run window by window."""
    got = ChaosHarness(compose(build("fleet", kind), 0.2, 0.5, seed=60),
                       steps_per_dispatch=6, crash_every=2)
    want = RHarness(compose(RSystem(MEMS, kind, rho_target=RHO,
                                    log2_te=R_WL.log2_te), 0.2, 0.5,
                            seed=60, mods=REF),
                    steps_per_dispatch=6, crash_every=2)
    schedule = window_start_schedule(TS)
    TS.Replayer(WL, N_SW).run(got, window=2, failures=schedule)
    assert {ev.epoch for ev in schedule.log} == {0, 2, 4}
    _run_windows(want, RS.Replayer(R_WL, N_SW), 2,
                 window_start_schedule(RS))
    assert got.n_dispatches == want.n_dispatches == N_EPOCHS // 2
    assert got.system._dead_at and not got.system.fleet._lost
    applied = assert_harness_parity(got, want, "fleet")
    assert got.verify_config_twin(lambda: build("fleet", kind)) == \
        len(applied)


@pytest.mark.parametrize("window", [2, 3])
@pytest.mark.parametrize("kind", ["cs", "cms"])
def test_fleet_window_matches_emulation_inside_windows(kind, window):
    """(c) Events inside windows: a death at a window offset past 0 loses
    the victim's earlier epochs of the window, resource pressure falls on
    any epoch (its resizes wait for the next dispatch).  The oracle is
    the reference's harness and planes around the emulation of its fleet
    window path; the twins are the port's fleet and the emulation."""
    got = ChaosHarness(compose(build("fleet", kind), 0.2, 0.5, seed=60),
                       steps_per_dispatch=6, crash_every=2)
    em = ChurnWindowEmulation(MEMS, kind, RHO, R_WL.log2_te, export=True)
    want = RHarness(compose(em, 0.2, 0.5, seed=60, mods=REF),
                    steps_per_dispatch=6, crash_every=2)
    schedule = chaos_schedule(TS)
    TS.Replayer(WL, N_SW).run(got, window=window, failures=schedule)
    assert any(ev.epoch % window for ev in schedule.log)
    _run_windows(want, RS.Replayer(R_WL, N_SW), window, chaos_schedule(RS))
    lost = {e: {got.system.fleet.frag_order[i] for i in v}
            for e, v in got.system.fleet._lost.items() if v}
    assert lost and lost == em.lost
    assert got.system.fleet._lost
    applied = assert_harness_parity(got, want, "fleet")
    for e, sws in em.lost.items():
        assert not any((sw, e) in want.staged for sw in sws)
    assert got.verify_config_twin(lambda: build("fleet", kind)) == \
        want.verify_config_twin(lambda: ChurnWindowEmulation(
            MEMS, kind, RHO, R_WL.log2_te)) == len(applied)


# -- the harness catches a fault -----------------------------------------------

def _tamper_cell(h):
    sw, e = min(h.export.collector.applied)
    cell = h.system.fleet.cell_counters(e, sw)
    h.system.fleet.deliver_cell(e, sw, cell + 1)
    h.verify_config_twin(lambda: build("fleet"))


def _drop_from_books(h):
    h.export.collector.applied.discard(min(h.export.collector.applied))
    h.check_partition(final=True)


def _forge_stale_entry(h):
    e = next(e for e in EPOCHS if e not in h.control._epoch_stale)
    h.control._epoch_stale[e] = [0]
    h.check_stale_ledger()


FAULTS = {"tampered applied cell": _tamper_cell,
          "staged cell dropped from the books": _drop_from_books,
          "forged stale-ledger entry": _forge_stale_entry}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_harness_catches_a_fault(fault):
    h = ChaosHarness(compose(build("fleet"), 0.2, 0.5, seed=60),
                     steps_per_dispatch=6, crash_every=2)
    TS.Replayer(WL, N_SW).run(h, window=2, failures=chaos_schedule(TS))
    h.finish()
    h.verify_config_twin(lambda: build("fleet"))   # clean before the fault
    with pytest.raises(ChaosInvariantError):
        FAULTS[fault](h)
