"""The per-layer metrics read from the program's own spans
(``perfbench/program_spans.py``): a traced CPU run of every cell at a
small size reports each of its metrics, finite and not negative; a
call's direct step spans and its untraced rest add up to its root span,
which lies inside the benchmark's span around the call.  A program
without the recorder, or a buffer that lost the window's first calls,
gives nothing to read."""
import math
import sys
from collections import deque
from pathlib import Path

import pytest

from perfbench import harness, program_spans, registry

from .sizes import CELLS, SMALL

BENCH = registry.benchmark()
METRICS = Path(harness.__file__).resolve().parent / "metrics"
#: The benchmark's span around each cell's calls into the program.
OP = {"cs-s61.ingest": "run_window", "um-s61.ingest": "run_window",
      "cs-s61.flowquery": "query_flows", "um-s61.entropy": "query_entropy"}


def _reads_program_spans(name: str) -> bool:
    return "program_spans" in (METRICS / f"{name}.py").read_text()


@pytest.fixture(scope="module")
def runs():
    """A traced CPU run of each cell: its result and its metric context."""
    made = {}
    seen = []

    class Capturing(harness.Context):
        def __init__(self, *a):
            super().__init__(*a)
            seen.append(self)

    real = harness.Context
    harness.Context = Capturing
    try:
        for cell in CELLS:
            out = harness.run_cell(cell, 2**31 + 29, 0.5, True,
                                   device="cpu", overrides=SMALL)
            made[cell] = (out["result"], seen[-1])
    finally:
        harness.Context = real
    return made


@pytest.mark.parametrize("cell", CELLS)
def test_every_program_span_metric_is_reported(runs, cell):
    res, _ = runs[cell]
    assert res["correct"] is True
    mine = [m["name"] for m in registry.metrics_of(cell, BENCH, "per_layer")
            if _reads_program_spans(m["name"])]
    assert mine
    for name in mine:
        assert name in res["metrics"], name
        v = res["metrics"][name]["value"]
        assert math.isfinite(v) and v >= 0, (name, v)


@pytest.mark.parametrize("cell", CELLS)
def test_steps_and_untraced_add_up_to_the_root(runs, cell):
    res, ctx = runs[cell]
    op = OP[cell]
    calls = program_spans.calls(ctx, op)
    assert calls
    root_ms = sum(c.ms for c in calls) / len(calls)
    direct = sum(c.direct_ms() for c in calls) / len(calls)
    untraced = res["metrics"][f"untraced_ms.{cell.split('.')[1]}"]["value"]
    assert direct + untraced == pytest.approx(root_ms, rel=1e-9, abs=1e-9)
    lat = ctx.run.latencies.get(op) or ctx.run.profiled_latencies.get(op)
    outer_ms = (res["metrics"]["run_window_ms"]["value"] if op == "run_window"
                else 1e3 * sum(lat) / len(lat))
    assert len(calls) == len(ctx.spans.durations(op))
    assert root_ms <= outer_ms


def test_nothing_to_read_without_the_recorder(runs, monkeypatch):
    import repro_torch

    _, ctx = runs["cs-s61.ingest"]
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    monkeypatch.delattr(repro_torch, "obs")
    assert program_spans._calls(ctx.spans.spans, "run_window") is None


def test_nothing_to_read_once_the_window_start_was_dropped(runs,
                                                           monkeypatch):
    from repro_torch import obs

    _, ctx = runs["cs-s61.ingest"]
    assert program_spans._calls(ctx.spans.spans, "run_window")
    last = obs.spans()[-1]
    monkeypatch.setattr(obs, "_buf", deque([last], maxlen=1))
    monkeypatch.setitem(obs._state, "dropped", 1)
    assert program_spans._calls(ctx.spans.spans, "run_window") is None
