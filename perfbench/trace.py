"""Spans around the benchmark's calls into the program, and the reduction
of a ``torch.profiler`` trace to device busy time, idle gaps, copies and
kernel time.

Spans are kept in memory as ``(name, start_ns, end_ns, profiled)`` from
the host clock.  In a traced run the profiler covers the last
``TRACE_SECONDS`` of the window (all of a shorter one): a profiled UnivMon
query runs ~10^5 host ops, and the trace of a whole window would take
longer to reduce than a run may last.  While it runs each span is also a
``record_function`` range, so the profiler's timeline carries it and an
idle gap of the device can be labelled by the span the host was in; the
spans' own metrics read the unprofiled part, which the profiler does not
slow.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "perfbench.window"
TRACE_SECONDS = 10.0
#: Device events that are the profiler's own, not the program's work.
_NOT_WORK = ("Activity Buffer",)


class Tracer:
    def __init__(self, profile: bool, cuda: bool):
        self.profile = profile
        self.cuda = cuda
        self.spans: List[Tuple[str, int, int, bool]] = []
        self._prof = None
        self._window = None

    @property
    def profiling(self) -> bool:
        return self._prof is not None

    @contextlib.contextmanager
    def span(self, name: str):
        rf = None
        if self._prof is not None:
            import torch

            rf = torch.profiler.record_function(name)
            rf.__enter__()
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter_ns(),
                               rf is not None))
            if rf is not None:
                rf.__exit__(None, None, None)

    def warm(self, device) -> None:
        """Start and stop the profiler once around a device op (traced runs,
        in set-up): its first start initializes CUPTI, ~8 s on the card's
        host, which would otherwise fall inside the window."""
        if not self.profile:
            return
        import torch

        self.start()
        torch.zeros(1, device=device).add_(1).cpu()
        self.stop()

    def start(self) -> None:
        """Start the profiler (traced runs; once)."""
        if not self.profile or self._prof is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        with warnings.catch_warnings():
            # one profiling cycle: its note on clearing events between
            # cycles says nothing here ("acc_events" would build every
            # event's FunctionEvent at stop, minutes for a UnivMon window)
            warnings.simplefilter("ignore", UserWarning)
            self._prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW_SPAN)
        self._window.__enter__()

    def stop(self) -> Optional[dict]:
        """Stop the profiler (the device already synchronized) and reduce
        its trace; None in an untraced run."""
        if self._prof is None:
            return None
        self._window.__exit__(None, None, None)
        prof, self._prof = self._prof, None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            prof.__exit__(None, None, None)
        return reduce_profile(prof.profiler.kineto_results.events(),
                              {s[0] for s in self.spans})

    def durations(self, name: str) -> List[float]:
        """Seconds of every span called ``name`` outside the profiled part
        of the window (of every one, where all were profiled)."""
        own = [s for s in self.spans if s[0] == name]
        free = [s for s in own if not s[3]]
        return [(b - a) * 1e-9 for _, a, b, _ in (free or own)]

    def write(self, path: str) -> None:
        """The spans as JSON lines (name, start and end in ns)."""
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            for n, a, b, profiled in self.spans:
                fh.write(json.dumps({"name": n, "start_ns": a, "end_ns": b,
                                     "profiled": profiled}) + "\n")


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce_profile(events, span_names) -> dict:
    """Device work in the traced window from the profiler's raw events
    (``kineto_results.events()``: building ``prof.events()`` costs some
    seconds per query of the UnivMon plane, whose queries run ~10^5 ops).

    Returns ``window_s`` (the traced window), ``busy_s`` (the union of the
    device's kernel, copy and fill intervals inside it), ``d2h`` (device
    to host copies), ``kernel_s`` (device seconds by event name),
    ``device_ops`` (the 10 names that took the most device time) and
    ``idle_gaps`` (the device's idle seconds split by the span the host
    was in, the 10 largest; "harness" outside every span)."""
    from torch.autograd import DeviceType

    window = None
    spans: List[Tuple[float, float, str]] = []
    dev: List[Tuple[float, float, str]] = []
    for e in events:
        kind, name = e.device_type(), e.name()
        if kind == DeviceType.CPU:
            if name == WINDOW_SPAN:
                window = (e.start_ns(), e.end_ns())
            elif name in span_names:
                spans.append((e.start_ns(), e.end_ns(), name))
        elif kind == DeviceType.CUDA:
            if (name in span_names or name == WINDOW_SPAN
                    or name.startswith(_NOT_WORK)
                    or (hasattr(e, "is_user_annotation")
                        and e.is_user_annotation())):
                continue
            dev.append((e.start_ns(), e.end_ns(), name))
    if window is None:
        raise RuntimeError("the profiler trace has no window span")
    w0, w1 = window
    kernel_s: Dict[str, float] = {}
    d2h = 0
    clipped = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        clipped.append((a, b))
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) * 1e-9
        if "DtoH" in name:
            d2h += 1
    busy = _merge(clipped)
    busy_s = sum(b - a for a, b in busy) * 1e-9
    spans.sort()
    idle: Dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    j = 0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        # the spans are siblings (no two overlap): sweep them once
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        covered = 0
        k = j
        while k < len(spans) and spans[k][0] < b:
            part = min(b, spans[k][1]) - max(a, spans[k][0])
            if part > 0:
                idle[spans[k][2]] = idle.get(spans[k][2], 0.0) + part * 1e-9
                covered += part
            k += 1
        if b - a > covered:
            idle["harness"] = idle.get("harness", 0.0) + (b - a - covered) * 1e-9
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy_s, "d2h": d2h,
            "kernel_s": kernel_s,
            "device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                                key=lambda kv: -kv[1])[:10]}
