"""The ``entropy_query`` loop: one resident pass, then ``query_entropy``
over every flow and its path, for one dispatch window of epochs a query
(each window in turn, in an order drawn from the seed), one operation a
query.

The comparison takes a sample of the window's queries drawn from the
seed (``check_queries``): ``entropy_rel_gap``, the largest relative gap
of an entropy from the plain reference's.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from perfbench.check import sample
from perfbench.timed import Run, answers_of, query_loop


def windows_of(h) -> List[List[int]]:
    """The epoch sets the queries draw from: ``"window"``, each dispatch
    window of the configuration."""
    if h.mix["epochs"] != "window":
        raise ValueError(f"unknown epochs {h.mix['epochs']!r}")
    E, W = h.inputs.n_epochs, int(h.cfg["window"])
    return [list(range(e0, min(e0 + W, E))) for e0 in range(0, E, W)]


def window_of(h, i: int) -> int:
    """Which epoch set query ``i`` asks about: the sets in an order drawn
    from the seed, each once before any repeats, so every run asks about
    each set as often (the warm query asks about the first)."""
    n = len(windows_of(h))
    if i < 0:
        return 0
    order = np.random.default_rng([int(h.seed), i // n, 7]).permutation(n)
    return int(order[i % n])


def run(h) -> Run:
    keys, paths = h.inputs.keys, h.inputs.paths()
    sets = windows_of(h)
    totals = [float(h.inputs.packets_in(es)) for es in sets]
    k_heavy = int(h.mix["k_heavy"])

    def pick(i):
        w = window_of(h, i)
        return (keys, paths, sets[w], totals[w], k_heavy), sets[w]

    def call(system, *args):
        return float(h.sut.query_entropy(system, *args))

    return query_loop(h, "query_entropy", pick, call)


def produced(h, run: Run) -> dict:
    return answers_of(run, h.sut)


def control(h, ctrl) -> dict:
    """The answers of ``ctrl`` (the reference in the control's precision)
    to the first ``check_queries`` queries."""
    sets = windows_of(h)
    picked = {i: sets[window_of(h, i)]
              for i in range(int(h.mix["check_queries"]))}
    ctrl.ingest(h.inputs.streams, keep={e for es in picked.values()
                                        for e in es})
    return {"answers": {i: _entropy(h, ctrl, es) for i, es in picked.items()},
            "query_epochs": picked}


def _entropy(h, fleet, epochs) -> float:
    return fleet.entropy(h.inputs.keys, h.inputs.path_mat, epochs,
                         float(h.inputs.packets_in(epochs)),
                         int(h.mix["k_heavy"]))


def compare(h, out: dict, ref_mod) -> Tuple[dict, dict]:
    picked = sample(h.seed, list(out["answers"]), int(h.mix["check_queries"]))
    ref = ref_mod.Reference(h.cfg)
    ref.ingest(h.inputs.streams,
               keep={e for i in picked for e in out["query_epochs"][i]})
    gap = 0.0
    for i in picked:
        want = _entropy(h, ref, out["query_epochs"][i])
        g = abs(float(out["answers"][i]) - want) / max(abs(want), 1e-30)
        gap = max(gap, g if math.isfinite(g) else math.inf)
    return {"entropy_rel_gap": gap}, {}
