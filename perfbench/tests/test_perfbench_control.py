"""The comparison that decides ``correct`` must fail the control (the
plain reference in bfloat16 in the program's place) and each fault the
timed path can have, planted in the program underneath a CPU run."""
import numpy as np
import pytest

from perfbench import check, harness, registry
from perfbench.control import control_numbers

from .sizes import CELLS, HEAVY, SMALL


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    ok, shown = check.verdict(control_numbers(cell, 5, HEAVY),
                              registry.limits(cell))
    assert not ok, shown


def _unchanged(monkeypatch, loop):
    from repro_torch.core.disketch import DiSketchSystem

    if loop == "ingest":      # a window step that leaves the state as it was
        monkeypatch.setattr(DiSketchSystem, "run_window",
                            lambda self, *a, **k: None)
    elif loop == "flow_query":
        monkeypatch.setattr(DiSketchSystem, "query_flows",
                            lambda self, keys, *a, **k: np.zeros(len(keys)))
    else:                     # the entropy of an empty sketch
        monkeypatch.setattr(DiSketchSystem, "query_entropy",
                            lambda self, keys, paths, epochs, total, **k:
                            float(np.log2(total)))


def _half(monkeypatch, loop):
    from repro_torch.core import fleet
    from repro_torch.core.disketch import DiSketchSystem

    if loop == "ingest":      # every other packet of the batch left out
        pack = fleet.pack_streams

        def half(streams, order):
            p = pack(streams, order)
            p.values[1::2] = 0
            return p
        monkeypatch.setattr(fleet, "pack_streams", half)
    elif loop == "flow_query":
        q = DiSketchSystem.query_flows

        def half(self, keys, paths, *a, **k):
            n = len(keys) // 2
            out = np.zeros(len(keys))
            out[:n] = q(self, keys[:n], paths[:n], *a, **k)
            return out
        monkeypatch.setattr(DiSketchSystem, "query_flows", half)
    else:
        q = DiSketchSystem.query_entropy

        def half(self, keys, paths, *a, **k):
            n = len(keys) // 2
            return q(self, keys[:n], paths[:n], *a, **k)
        monkeypatch.setattr(DiSketchSystem, "query_entropy", half)


def _altered(monkeypatch, loop):
    from repro_torch.core.disketch import DiSketchSystem
    from repro_torch.core.fleet import FleetEpochRunner

    if loop == "ingest":      # one counter off by one where it is made
        run = FleetEpochRunner.run_window

        def bump(self, epoch0, *a, **k):
            out = run(self, epoch0, *a, **k)
            self._window_bufs[epoch0][0].device()[0][1][0, 0, 0, 0] += 1
            return out
        monkeypatch.setattr(FleetEpochRunner, "run_window", bump)
    elif loop == "flow_query":
        q = DiSketchSystem.query_flows

        def bump(self, *a, **k):
            out = q(self, *a, **k)
            out[int(np.argmax(out))] += 1.0
            return out
        monkeypatch.setattr(DiSketchSystem, "query_flows", bump)
    else:
        q = DiSketchSystem.query_entropy
        monkeypatch.setattr(DiSketchSystem, "query_entropy",
                            lambda self, *a, **k: q(self, *a, **k) * 1.001)


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    loop = registry.traffic(registry.workload(
        cell, registry.benchmark())["traffic"])["loop"]
    FAULTS[fault](monkeypatch, loop)
    out = harness.run_cell(cell, 31, 0.5, False, device="cpu",
                           overrides=SMALL)
    assert out["result"]["correct"] is False, out["result"]["compared"]
