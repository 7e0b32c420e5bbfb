"""The ``ingest`` loop: the inputs as windows of the configuration's
epochs, each epoch packed by ``pack_streams`` and each window dispatched
by ``run_window``, as ``Replayer.run`` does, on a fresh system per pass
(the program keeps every window it has run); passes back to back, one
operation a pass.

The comparison takes the window's last pass: ``counter_mismatch``, the
counters of every (epoch, fragment, level) cell that differ from the
plain reference's (a cell missing or of another shape counts whole),
plus the entries of the Eq. 6 trajectory (``n_log``) that differ; and
``peb_rel_gap``, the largest relative gap of a PEB.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from perfbench.timed import Run, window


def run(h) -> Run:
    run = Run()
    sut = h.sut
    run.events_per_pass = h.inputs.events()
    run.param_rows_per_pass = h.inputs.n_epochs * sut.param_rows_per_epoch()
    sut.ingest_pass(sut.new_system(), h.tracer)           # warm pass

    def step(i):
        run.system = None                                 # free the last
        run.system = sut.new_system()
        run.windows += sut.ingest_pass(run.system, h.tracer)
        run.events += run.events_per_pass

    window(h, run, step)
    return run


def produced(h, run: Run) -> dict:
    """The last pass's counters, trajectory and PEBs; the program's state
    is dropped."""
    system, run.system = run.system, None
    sut = h.sut
    if system is None:
        out = {"cells": {}, "n_log": [], "pebs": []}
    else:
        out = {"cells": {(e, f): sut.cell(system, e, f)
                         for e in range(h.inputs.n_epochs)
                         for f in range(sut.n_frags)},
               "n_log": sut.n_log(system), "pebs": sut.peb_log(system)}
    del system
    sut.release()
    return out


def control(h, ctrl) -> dict:
    """The same outputs from ``ctrl``, the reference in the control's
    precision, put in the program's place."""
    ctrl.ingest(h.inputs.streams)
    return {"cells": ctrl.counters, "n_log": ctrl.n_log, "pebs": ctrl.pebs}


def compare(h, out: dict, ref_mod) -> Tuple[dict, dict]:
    numbers, touched = numbers_of(
        ref_mod.Reference(h.cfg), h.inputs.streams,
        lambda e, f: out["cells"].get((e, f)), out["n_log"], out["pebs"])
    return numbers, {"counters_touched": touched}


def numbers_of(ref, streams: Sequence[dict],
               cell: Callable[[int, int], Optional[np.ndarray]],
               n_log: Sequence, pebs: Sequence) -> Tuple[dict, int]:
    """Run the reference ``ref`` over ``streams`` and compare, window by
    window, with the program's ``cell(epoch, frag)`` counters; then the
    trajectory ``n_log[e][f]`` and ``pebs[e][f]``.  Returns the numbers
    and the reference's non-zero counters (B1's written counters)."""
    out = {"counter_mismatch": 0, "peb_rel_gap": 0.0}
    touched = [0]

    def compare_window(eps):
        for e in eps:
            for f in range(ref.n_frags):
                r = ref.counters.pop((e, f))
                touched[0] += int(np.count_nonzero(r))
                p = cell(e, f)
                if p is None or np.shape(p) != r.shape:
                    out["counter_mismatch"] += max(r.size, np.size(p))
                else:
                    out["counter_mismatch"] += int(np.count_nonzero(
                        np.asarray(p, np.float64) != r))

    ref.ingest(streams, on_window=compare_window)
    for e, want in enumerate(ref.n_log):
        got = n_log[e] if e < len(n_log) else {}
        out["counter_mismatch"] += sum(1 for f, n in enumerate(want)
                                       if _get(got, f) != n)
    for e, want in enumerate(ref.pebs):
        got = pebs[e] if e < len(pebs) else {}
        for f, r in enumerate(want):
            p = _get(got, f)
            gap = math.inf if p is None else abs(p - r) / max(abs(r), 1e-30)
            out["peb_rel_gap"] = max(out["peb_rel_gap"], gap)
    return out, touched[0]


def _get(seq, f):
    if isinstance(seq, dict):
        return seq.get(f)
    return seq[f] if f < len(seq) else None
