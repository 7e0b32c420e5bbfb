"""The program's own spans (``repro_torch.obs``) inside the benchmark's.

Each of the benchmark's spans around a call into the program
(``run_window``, ``query_flows``, ``query_entropy``) holds one root span
the program records itself (``disketch.run_window``, ...), and under it
the spans of the call's steps.  Only the calls inside the benchmark's
unprofiled spans are read (of every one, where all were profiled, as
``Tracer.durations`` does): the profiler slows the others.

Every figure is a mean per call: per dispatched window or per query.
Each reader returns None where there is nothing to read: a program
without the recorder, no such call, or a buffer that no longer reaches
back to the first call read.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

#: The program's root span inside each of the benchmark's spans.
ROOTS = {"run_window": "disketch.run_window",
         "query_flows": "disketch.query_flows",
         "query_entropy": "disketch.query_entropy"}


class Call:
    """One call into the program: its root span and every span under it."""

    def __init__(self, root):
        self.root = root
        self.spans: List[object] = []

    @property
    def ms(self) -> float:
        return (self.root.end_ns - self.root.start_ns) * 1e-6

    def direct_ms(self) -> float:
        """Time of the root's direct children (ms)."""
        return sum(s.end_ns - s.start_ns for s in self.spans
                   if s.parent == self.root.id) * 1e-6


def calls(ctx, op: str) -> Optional[List[Call]]:
    """The program's calls inside the benchmark's ``op`` spans, cached on
    ``ctx``; None where there are none or the buffer lost some."""
    cache: Dict[str, Optional[List[Call]]] = ctx.__dict__.setdefault(
        "program_calls", {})
    if op not in cache:
        cache[op] = _calls(ctx.spans.spans, op)
    return cache[op]


def _calls(bench_spans, op: str) -> Optional[List[Call]]:
    try:
        from repro_torch import obs
    except ImportError:          # a program without the recorder
        return None
    own = [s for s in bench_spans if s[0] == op]
    outer = [s for s in own if not s[3]] or own
    recs = obs.spans()
    if not outer or not recs:
        return None
    outer.sort(key=lambda s: s[1])
    if obs.dropped() and outer[0][1] <= recs[0].end_ns:
        return None              # the oldest calls' records were dropped
    roots = sorted((r for r in recs
                    if r.parent is None and r.name == ROOTS[op]),
                   key=lambda r: r.start_ns)
    found: Dict[int, Call] = {}
    j = 0
    for _, a, b, _ in outer:
        while j < len(roots) and roots[j].start_ns < a:
            j += 1
        if j < len(roots) and roots[j].end_ns <= b:
            found[roots[j].id] = Call(roots[j])
            j += 1
    for r in recs:
        if r.parent is not None and r.root in found:
            found[r.root].spans.append(r)
    return list(found.values()) or None


def _mean(ctx, op: str, per_call: Callable[[Call], float]
          ) -> Optional[float]:
    cs = calls(ctx, op)
    if not cs:
        return None
    return sum(per_call(c) for c in cs) / len(cs)


def step_ms(ctx, op: str, name: str) -> Optional[float]:
    """Mean ms a call spends in the spans called ``name``."""
    return _mean(ctx, op, lambda c: sum(
        s.end_ns - s.start_ns for s in c.spans if s.name == name) * 1e-6)


def wait_ms(ctx, op: str) -> Optional[float]:
    """Mean ms a call waits for the device: its ``*.wait`` spans."""
    return _mean(ctx, op, lambda c: sum(
        s.end_ns - s.start_ns for s in c.spans
        if s.name.endswith(".wait")) * 1e-6)


def waits(ctx, op: str) -> Optional[float]:
    """Mean ``*.wait`` spans a call: the host's reads of device data."""
    return _mean(ctx, op, lambda c: sum(
        1 for s in c.spans if s.name.endswith(".wait")))


def counted(ctx, op: str, key: str,
            name: Optional[str] = None) -> Optional[float]:
    """Mean total of count ``key`` a call, over its root and its spans
    (those called ``name`` only, where given)."""
    def total(c: Call) -> float:
        return sum((s.counts or {}).get(key, 0) for s in [c.root] + c.spans
                   if name is None or s.name == name)
    return _mean(ctx, op, total)


def untraced_ms(ctx, op: str) -> Optional[float]:
    """Mean ms of a root covered by none of its direct children."""
    return _mean(ctx, op, lambda c: c.ms - c.direct_ms())
