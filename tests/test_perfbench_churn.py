"""The churn cell of the port's benchmark (``cs-s61.churn-ingest``) on
the CPU at a small size: the program under a failure schedule against the
plain reference ``perfbench/reference/disketch_churn.py``, each fault the
churn path can have planted in the program, the control in bfloat16, and
the churn spans' counts.

The schedule mirrors the cell's at 12 epochs in windows of 4: switches 1,
3 and 12 die at offset 1 of window 4-7 and rejoin at offset 1 of window
8-11, so epoch 4 holds three lost cells, of which parity rebuilds one (12
is alone in its group; 1 and 3 share group 0).  A low ``rho_target`` makes
Eq. 6 and the §6 re-equalization move n.
"""
import numpy as np
import pytest

from perfbench import harness, registry
from perfbench.control import control_numbers
from perfbench.reference import disketch_churn as ref_churn

CELL = "cs-s61.churn-ingest"
SEED = 2**31 + 29
DOWNS = {"1": [5, 9], "3": [5, 9], "12": [5, 9]}
SMALL = {"trace": {"n_flows": 3000, "total_packets": 45000, "n_epochs": 12},
         "window": 4, "rho_target": 0.3, "failures": {"downs": DOWNS}}
#: Counters past bfloat16's 256 exact integers, so the control shows.
HEAVY = {"trace": {"n_flows": 3000, "total_packets": 200000, "n_epochs": 4},
         "window": 2, "failures": {"downs": {"1": [1, 3], "12": [1, 3]}}}
CHURN_SPANS = ("fleet.mask", "fleet.parity", "fleet.lose", "fleet.recover",
               "disketch.apply_event")


@pytest.fixture(autouse=True)
def _jax_elsewhere_in_the_process(monkeypatch):
    """Other test files load the JAX package into this process; the guard
    against it is for benchmark processes, which hold nothing else."""
    monkeypatch.setattr(harness, "FORBIDDEN", ())


def _run(trace=False, seconds=0.2, overrides=SMALL, cell=CELL):
    return harness.run_cell(cell, SEED, seconds, trace, device="cpu",
                            overrides=overrides)


def test_the_configuration_holds_the_pinned_schedule():
    """The victims are those of the seeded schedule the smoke pins, and the
    reference finds the smoke's lost and recoverable cells."""
    from repro_torch.net.simulator import FailureSchedule

    cfg = registry.config("disketch-cs-s61-churn", registry.benchmark())
    base = registry.config("disketch-cs-s61", registry.benchmark())
    for k, v in base.items():       # the fleet, memories and trace of 6.1
        if k not in ("name", "source", "system", "reference", "deployment",
                     "guarantees", "assumed"):
            assert cfg[k] == v, k
    assert set(base["assumed"]) < set(cfg["assumed"])
    seeded = FailureSchedule.random(20, 0.25, down_epoch=17, up_epoch=25,
                                    seed=3)
    assert ref_churn.downs_of(cfg) == seeded.downs
    wins = ref_churn.windows(cfg, 32)
    lost = {e: sorted(s) for w in wins for e, s in zip(w.epochs, w.lost) if s}
    assert lost == {16: [1, 3, 4, 12, 19]}
    live = ref_churn.liveness(cfg, 32)
    assert sorted(np.flatnonzero(~live[16])) == [1, 3, 4]
    assert all(sorted(np.flatnonzero(~live[e])) == [1, 3, 4, 12, 19]
               for e in range(17, 25))
    assert live[:16].all() and live[25:].all()


def test_the_reference_detects_as_the_port_schedule_does():
    """Each epoch's events of the reference are those the port's
    ``FailureSchedule`` emits through its heartbeat monitor."""
    from repro_torch.net.simulator import FailureSchedule

    cfg = registry.config("disketch-cs-s61-churn", registry.benchmark())
    sched = FailureSchedule(20, ref_churn.downs_of(cfg))
    for w in ref_churn.windows(cfg, 32):
        for e, events in zip(w.epochs, w.events):
            assert [(ev.kind, ev.switch) for ev in sched.advance(e)] \
                == events


def test_the_program_matches_the_reference():
    res = _run()["result"]
    got = {k: v["value"] for k, v in res["compared"].items()}
    assert res["correct"] is True, got
    assert got["counter_mismatch"] == got["liveness_mismatch"] == 0
    assert got["est_rel_gap"] == 0.0
    assert got["peb_rel_gap"] <= 1e-12


def _no_masking(monkeypatch):
    from repro_torch.core import fleet

    monkeypatch.setattr(fleet, "mask_fragment_values", lambda p, pos: p)


def _lost_not_zeroed(monkeypatch):
    from repro_torch.core import fleet

    monkeypatch.setattr(fleet._WindowBuffer, "zero", lambda self, *a: None)


def _recovery_skipped(monkeypatch):
    from repro_torch.core.fleet import FleetEpochRunner

    monkeypatch.setattr(FleetEpochRunner, "recover", lambda self, *a: {})


def _unrecoverable_recovered(monkeypatch):
    from repro_torch.core.fleet import FleetEpochRunner

    def every_lost(self, epochs=None):
        return {e: [self.frag_order[i] for i in sorted(lost)]
                for e, lost in self._lost.items() if lost}
    monkeypatch.setattr(FleetEpochRunner, "recoverable", every_lost)


def _no_reequalization(monkeypatch):
    from repro_torch.core.disketch import DiSketchSystem

    monkeypatch.setattr(DiSketchSystem, "_reequalize_survivors",
                        lambda self: None)


def _rejoin_keeps_n(monkeypatch):
    from repro_torch.core.disketch import DiSketchSystem

    apply = DiSketchSystem.apply_event

    def keep_n(self, event, **kw):
        n = self.ns[event.switch]
        apply(self, event, **kw)
        if event.kind == "recover":
            self.ns[event.switch] = n
    monkeypatch.setattr(DiSketchSystem, "apply_event", keep_n)


FAULTS = {"no masking": _no_masking, "lost not zeroed": _lost_not_zeroed,
          "recovery skipped": _recovery_skipped,
          "unrecoverable recovered": _unrecoverable_recovered,
          "no re-equalization": _no_reequalization,
          "rejoin keeps its n": _rejoin_keeps_n}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_churn_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = _run()["result"]
    assert res["correct"] is False, res["compared"]


def test_the_control_is_not_correct():
    from perfbench import check

    ok, shown = check.verdict(control_numbers(CELL, 5, HEAVY),
                              registry.limits(CELL))
    assert not ok, shown


def test_the_churn_spans_count_what_the_schedule_does(monkeypatch):
    """Per pass: every victim's epoch before its death lost, the lone
    victim's cell rebuilt, and every packet the victims forwarded while
    dead masked."""
    seen = []

    class Capturing(harness.Context):
        def __init__(self, *a):
            super().__init__(*a)
            seen.append(self)

    monkeypatch.setattr(harness, "Context", Capturing)
    res = _run(trace=True, seconds=0.5)["result"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    for name in ("mask_ms.churn", "masked_packets.churn", "parity_ms.churn",
                 "parity_mb.churn", "apply_event_ms.churn",
                 "lost_cells.churn", "recover_ms.churn",
                 "recovered_cells.churn"):
        assert name in m and m[name] >= 0, name
    windows = 3
    assert m["lost_cells.churn"] * windows == 3
    assert m["recovered_cells.churn"] == 1
    streams = seen[-1].h.inputs.streams
    dead = sum(len(streams[e][int(sw)][0]) for sw, (d, u) in DOWNS.items()
               for e in range(d, u) if int(sw) in streams[e])
    assert m["masked_packets.churn"] * windows == dead
    assert m["parity_mb.churn"] > 0


def test_the_fault_free_cell_opens_no_churn_span():
    from repro_torch import obs

    obs.clear()
    res = _run(cell="cs-s61.ingest",
               overrides={"trace": SMALL["trace"], "window": 4})["result"]
    assert res["correct"] is True
    assert not [s.name for s in obs.spans() if s.name in CHURN_SPANS]
