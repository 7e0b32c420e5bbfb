"""Everything the harness runs is found by the names in ``BENCHMARK.json``:

* a configuration: the JSON file its entry names (``configs[].file``),
  whose ``inputs`` names the generator in ``perfbench/gen/`` that makes
  its inputs from the seed, whose ``system`` names the adapter of the
  program in ``perfbench/systems/`` and whose ``reference`` names the
  plain reference in ``perfbench/reference/``;
* a traffic mix: ``perfbench/traffic/<traffic>.json``, a data file of
  parameters whose ``loop`` names the module in ``perfbench/loops/``
  that runs it and compares what it produced (``run``, ``produced``,
  ``control``, ``compare``);
* a metric: ``perfbench/metrics/<metric>.py`` and its ``read(ctx)``;
* a cell's limits on the numbers ``correct`` compares:
  ``perfbench/limits/<workload>.json``.

A later cell, mix, loop, system or metric adds files and entries; none of
these is edited.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def workload(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, bench: dict) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as fh:
                return json.load(fh)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def loop(name: str) -> ModuleType:
    return importlib.import_module(f"perfbench.loops.{name}")


def inputs(cfg: dict) -> Callable:
    """``make(cfg, seed)`` of the configuration's generator."""
    return importlib.import_module(f"perfbench.gen.{cfg['inputs']}").make


def system(cfg: dict) -> ModuleType:
    return importlib.import_module(f"perfbench.systems.{cfg['system']}")


def reference(cfg: dict) -> ModuleType:
    return importlib.import_module(f"perfbench.reference.{cfg['reference']}")


def limits(workload_name: str) -> Dict[str, dict]:
    with open(HERE / "limits" / f"{workload_name}.json") as fh:
        return json.load(fh)


def metric_reader(name: str) -> Callable:
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(workload_name: str, bench: dict, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it, and the end-to-end ones that list no cells (every cell
    reports them)."""
    if kind == "per_layer":
        return [m for m in bench["per_layer"]
                if workload_name in m["workloads"]]
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or workload_name in m["workloads"]]
