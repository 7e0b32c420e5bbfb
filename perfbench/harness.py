"""One run of one cell: set-up, the timed window, the comparison with the
plain reference, the metrics, and the result's last line.

``run_cell`` is what ``run.py`` calls; tests call it with the chip check
off and the CPU plain path, at a small size.
"""
from __future__ import annotations

import math
import os
import sys
import time
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np

from . import check, registry
from .timed import Run
from .trace import Tracer

#: Top-level module names the process may not hold once the window has
#: closed: the JAX package and JAX itself (compared whole, so the port,
#: whose name begins with the JAX package's, is not mistaken for it).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Harness:
    """What a loop reads: the cell's configuration, mix and inputs, and,
    in a run, the program under test and the tracer."""
    cfg: dict
    mix: dict
    inputs: object
    seed: int
    loop: ModuleType
    reference: ModuleType
    limits: dict
    sut: object = None
    tracer: Optional[Tracer] = None
    seconds: float = 0.0
    t_start: float = 0.0


def forbidden_modules() -> List[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) else v
    return out


def _finite(x):
    return x if x is None or math.isfinite(x) else None


def prepare(name: str, seed: int,
            overrides: Optional[dict] = None) -> Harness:
    """Cell ``name``'s configuration, mix, loop, reference and limits, and
    its inputs made from ``seed``: all found by name."""
    bench = registry.benchmark()
    cell = registry.workload(name, bench)
    cfg = _merge(registry.config(cell["config"], bench), overrides)
    mix = registry.traffic(cell["traffic"])
    return Harness(cfg, mix, registry.inputs(cfg)(cfg, seed), int(seed),
                   registry.loop(mix["loop"]), registry.reference(cfg),
                   registry.limits(name))


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: Optional[float] = None,
             overrides: Optional[dict] = None,
             spans_dir: Optional[str] = None) -> Dict:
    """Run cell ``name`` and return ``{"result": last line's object,
    "lines": the comparison's lines for standard error}``.

    ``overrides`` replace keys of the configuration (tests shrink the
    inputs); ``device="cpu"`` runs the program's plain versions."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = registry.benchmark()
    cell = registry.workload(name, bench)
    marks = [("start", time.perf_counter())]
    h = prepare(name, seed, overrides)
    marks.append(("inputs", time.perf_counter()))
    h.sut = registry.system(h.cfg).UnderTest(h.cfg, h.inputs, device)
    marks.append(("program", time.perf_counter()))
    h.tracer = Tracer(profile=trace, cuda=h.sut.device.type == "cuda")
    h.tracer.warm(h.sut.device)
    h.seconds, h.t_start = float(seconds), t_start
    run = h.loop.run(h)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"perfbench: the process holds {bad} after the "
                         "window; the benchmark may load no JAX package")

    # the program's outputs are read first and its state dropped; then
    # the plain reference runs on the host
    numbers, found = h.loop.compare(h, h.loop.produced(h, run), h.reference)
    ok, shown = check.verdict(numbers, h.limits)
    ok = ok and run.failed == 0 and run.attempted > 0
    ctx = Context(h, run, found)
    kinds = ("per_layer",) if trace else ("end_to_end",)
    metrics = {}
    for kind in kinds:
        for m in registry.metrics_of(name, bench, kind):
            v = registry.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    sut = h.sut
    device_info = {"platform": "gpu" if sut.device.type == "cuda" else "cpu",
                   "kind": _device_name(sut), "count": int(cell["chips"]),
                   "memory_peak_bytes": run.memory_peak}
    result = {"correct": bool(ok), "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": device_info}
    if trace and run.profile is not None:
        device_info["busy_s"] = run.profile["busy_s"]
        device_info["window_s"] = run.profile["window_s"]
        result["breakdown"] = {"device_ops": run.profile["device_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
    if trace and spans_dir:
        h.tracer.write(os.path.join(spans_dir, f"{name}.{seed}.spans.jsonl"))
    result["compared"] = {k: {"value": _finite(v["value"]),
                              "limit": v["limit"]} for k, v in shown.items()}
    marks.append(("warm", t_start + run.setup_s))
    lines = ["perfbench: set-up " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.2f} s" for a, b in zip(marks, marks[1:]))
        + f" (after {marks[0][1] - t_start:.2f} s of imports); window "
        f"{run.window_s:.3f} s: {run.attempted} operations "
        f"({', '.join(f'{n} {k}' for k, n in run.ops.items()) or 'none'}; "
        f"{run.profiled_ops} profiled after a "
        f"{run.profile_start_s:.2f} s profiler start)"]
    if run.errors:
        lines.append(f"perfbench: {len(run.errors)} operations raised; "
                     f"first: {run.errors[0]}")
    if run.loads_in_window:
        lines.append(f"perfbench: libraries loaded inside the window: "
                     f"{run.loads_in_window}")
    lines += [f"compared {k}: {v['value']!r} (limit {v['limit']!r})"
              for k, v in shown.items()]
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"perfbench: the process holds {bad}; the "
                         "benchmark may load no JAX package")
    return {"result": result, "lines": lines}


def _device_name(sut) -> str:
    if sut.device.type == "cuda":
        import torch

        return torch.cuda.get_device_name(sut.device)
    return "cpu"


class Context:
    """What a metric reader sees: the run, its spans and trace, and what
    the comparison found (``found``, such as the counters written)."""

    def __init__(self, h: Harness, run: Run, found: dict):
        self.h = h
        self.run = run
        self.spans = h.tracer
        self.profile = run.profile
        self.found = found

    def per_op(self, op: str, x: float) -> Optional[float]:
        n = self.run.ops.get(op, 0)
        return x / n if n else None

    def per_profiled_op(self, x: float) -> Optional[float]:
        n = self.run.profiled_ops
        return x / n if n else None

    def p95_ms(self, op: str) -> Optional[float]:
        lat = (self.run.latencies.get(op)
               or self.run.profiled_latencies.get(op))
        return float(np.percentile(lat, 95)) * 1e3 if lat else None
