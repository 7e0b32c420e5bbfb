"""What every timed loop shares: the record of a run, the measured window,
and the closed loop of queries against one resident pass.

Every loop is closed: the next operation is issued when the last one has
returned.  Set-up (inputs, system, warm work) comes before the window;
the window runs whole operations until ``seconds`` have passed and ends
in a device synchronize, and every end-to-end figure is taken over all
the work and all the time of the window.  One operation is one call of
the loop's ``step``: a pass or a query.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .trace import TRACE_SECONDS


@dataclass
class Run:
    """What a timed loop measured and produced."""

    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    #: completed operations of the window by the program call they time
    ops: Dict[str, int] = field(default_factory=dict)
    #: host seconds of each operation by name, outside the profiled part
    #: of the window (of every one, in a window profiled whole)
    latencies: Dict[str, List[float]] = field(default_factory=dict)
    profiled_latencies: Dict[str, List[float]] = field(default_factory=dict)
    #: dispatched windows and events handed to the system (ingest loops)
    windows: int = 0
    events: int = 0
    events_per_pass: int = 0
    param_rows_per_pass: int = 0
    #: operations while the profiler ran
    profiled_ops: int = 0
    profile_start_s: float = 0.0
    #: the program's counters' growth over the window
    counters: Dict[str, int] = field(default_factory=dict)
    loads_in_window: Dict[str, int] = field(default_factory=dict)
    profile: Optional[dict] = None
    memory_peak: int = 0
    errors: List[str] = field(default_factory=list)
    #: the program's state and answers, for the comparison
    system: object = None
    answers: Dict[int, object] = field(default_factory=dict)
    query_epochs: Dict[int, List[int]] = field(default_factory=dict)

    def done(self, op: str, seconds: float, profiled: bool) -> None:
        """One completed ``op`` that took ``seconds`` on the host clock."""
        self.ops[op] = self.ops.get(op, 0) + 1
        lat = self.profiled_latencies if profiled else self.latencies
        lat.setdefault(op, []).append(seconds)


def draw(seed: int, i: int) -> np.random.Generator:
    """The generator of query ``i`` (-1: the warm query) of a run."""
    return np.random.default_rng([int(seed), i + 1])


def window(h, run: Run, step: Callable[[int], None]) -> None:
    """Run ``step(i)`` until ``h.seconds`` have passed; one operation a
    call, a failure where it raises."""
    sut = h.sut
    sut.sync()
    run.setup_s = time.perf_counter() - h.t_start
    counters0, loads0 = sut.counters(), sut.library_loads()
    h.tracer.spans.clear()                # the set-up's own
    t0 = time.perf_counter()
    i = 0
    while True:
        if (not h.tracer.profiling
                and time.perf_counter() - t0 >= h.seconds - TRACE_SECONDS):
            s0 = time.perf_counter()
            h.tracer.start()              # traced runs: the last seconds
            run.profile_start_s = time.perf_counter() - s0
        profiled = h.tracer.profiling
        run.attempted += 1
        try:
            step(i)
        except Exception as exc:     # an answer that never came
            run.failed += 1
            run.errors.append(f"{type(exc).__name__}: {exc}")
        run.profiled_ops += profiled
        i += 1
        if time.perf_counter() - t0 >= h.seconds:
            break
    sut.sync()
    run.window_s = time.perf_counter() - t0
    run.profile = h.tracer.stop()
    run.counters = {k: v - counters0.get(k, 0)
                    for k, v in sut.counters().items()}
    loads = sut.library_loads()
    run.loads_in_window = {k: v - loads0.get(k, 0) for k, v in loads.items()
                           if v - loads0.get(k, 0)}
    run.memory_peak = sut.memory_peak()


def query_loop(h, op: str, pick: Callable[[int], Tuple[tuple, List[int]]],
               call: Callable[..., object]) -> Run:
    """One resident pass of the inputs, a warm query, then the window's
    queries.  ``pick(i)`` draws query ``i``'s arguments and the epochs it
    asks about; ``call(system, *args)``, timed on the host clock and
    spanned as ``op``, answers it."""
    run = Run()
    run.system = h.sut.new_system()
    h.sut.ingest_pass(run.system, h.tracer)
    call(run.system, *pick(-1)[0])                        # warm query

    def step(i):
        args, epochs = pick(i)
        profiled = h.tracer.profiling
        t = time.perf_counter()
        with h.tracer.span(op):
            answer = call(run.system, *args)
        run.done(op, time.perf_counter() - t, profiled)
        run.answers[i] = answer
        run.query_epochs[i] = epochs

    window(h, run, step)
    return run


def answers_of(run: Run, sut) -> dict:
    """A query loop's outputs for the comparison; the program's state is
    dropped."""
    run.system = None
    sut.release()
    return {"answers": run.answers, "query_epochs": run.query_epochs}
