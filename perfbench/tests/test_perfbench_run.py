"""A run's last line against the contract, and the runs that must refuse
to print one."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness, registry

from .sizes import CELLS, SMALL

ROOT = Path(__file__).resolve().parents[2]
BENCH = registry.benchmark()


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line_has_the_contract_keys(cell, trace):
    out = harness.run_cell(cell, 2**31 + 17, 0.5, bool(trace), device="cpu",
                           overrides=SMALL)
    res = json.loads(json.dumps(out["result"]))
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown", "compared"] if trace else ["compared"]
    assert list(res) == want
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"]: m["unit"]
             for m in registry.metrics_of(cell, BENCH, kind)}
    assert set(res["metrics"]) <= set(names)
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == names[name]
    if not trace:       # every end-to-end metric is read on any device
        assert set(res["metrics"]) == set(names)
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert dev["window_s"] > 0 and "busy_s" in dev
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(res["compared"]) == set(registry.limits(cell))
    for v in res["compared"].values():
        assert set(v) == {"value", "limit"}
    assert out["lines"][-len(res["compared"]):] == [
        f"compared {k}: {float(v['value'])!r} (limit {float(v['limit'])!r})"
        for k, v in res["compared"].items()]


def _run(cwd, *args):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "perfbench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_refuses_without_a_card():
    p = _run(ROOT, "--workload", "cs-s61.ingest", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_refuses_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, "--workload", "cs-s61.ingest", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_refuses_a_process_holding_the_jax_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro", type(sys)("repro"))
    with pytest.raises(SystemExit, match="repro"):
        harness.run_cell("cs-s61.ingest", 3, 0.2, False, device="cpu",
                         overrides=SMALL)
    assert harness.forbidden_modules() == ["repro"]
    monkeypatch.delitem(sys.modules, "repro")
    monkeypatch.setitem(sys.modules, "repro_torch_extra", type(sys)("x"))
    assert harness.forbidden_modules() == []


def test_attempted_and_failed_count_the_same_operations():
    """One operation a call of the loop's step: a pass or a query."""
    import time
    from types import SimpleNamespace

    from perfbench.timed import Run, window
    from perfbench.trace import Tracer

    sut = SimpleNamespace(sync=lambda: None, counters=lambda: {},
                          library_loads=lambda: {}, memory_peak=lambda: 0)
    h = SimpleNamespace(sut=sut, tracer=Tracer(False, False), seconds=0.05,
                        t_start=time.perf_counter())

    def step(i):
        time.sleep(0.002)
        if i % 2:
            raise ValueError("odd")

    run = Run()
    window(h, run, step)
    assert run.attempted >= 2 and run.failed == run.attempted // 2
    assert len(run.errors) == run.failed
