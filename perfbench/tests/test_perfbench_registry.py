"""BENCHMARK.json against the benchmark's contract, the registry against
BENCHMARK.json, and the imports of every benchmark module."""
import ast
import json
import re
from pathlib import Path

import pytest

from perfbench import registry

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    # a full check of 24 cells must fit its 43 200 s
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"]) and _line(c["source"])
        assert c["file"].startswith("perfbench/") and c["file"] not in files
        files.add(c["file"])
        assert c["reduced"] == []
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert len({c["source"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_workloads():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert len({w["name"] for w in BENCH["workloads"]}) == len(pairs)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        layers.setdefault(m["layer"], m["layer"])
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", sorted(w["name"] for w in BENCH["workloads"]))
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in registry.metrics_of(cell, BENCH, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert registry.metrics_of(cell, BENCH, "per_layer")


@pytest.mark.parametrize("name", sorted(
    m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]))
def test_registry_finds_metric(name):
    assert callable(registry.metric_reader(name))


@pytest.mark.parametrize("cell", sorted(w["name"] for w in BENCH["workloads"]))
def test_registry_finds_config_traffic_and_limits(cell):
    w = registry.workload(cell, BENCH)
    cfg = registry.config(w["config"], BENCH)
    assert callable(registry.inputs(cfg))
    assert hasattr(registry.system(cfg), "UnderTest")
    assert hasattr(registry.reference(cfg), "Reference")
    loop = registry.loop(registry.traffic(w["traffic"])["loop"])
    for fn in ("run", "produced", "control", "compare"):
        assert callable(getattr(loop, fn)), fn
    for name, lim in registry.limits(cell).items():
        assert lim["limit"] is not None and lim["limit"] >= 0, name


BENCH_FILES = sorted(p for p in (ROOT / "perfbench").rglob("*.py")
                     if "tests" not in p.relative_to(ROOT).parts)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                pkg = path.relative_to(ROOT).parts[:-node.level]
                yield ".".join(pkg + ((node.module,) if node.module else ()))
            else:
                yield node.module


@pytest.mark.parametrize("path", BENCH_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    """Top-level names compared whole: ``repro_torch`` is not ``repro``;
    the plain reference imports nothing of the program either."""
    banned = {"jax", "jaxlib", "flax", "repro"}
    if "reference" in path.relative_to(ROOT).parts:
        banned |= {"repro_torch"}
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & banned, sorted(tops & banned)
    if "reference" in path.relative_to(ROOT).parts:
        assert not any(m.startswith("perfbench.") and not
                       m.startswith("perfbench.reference")
                       for m in _imports(path))
