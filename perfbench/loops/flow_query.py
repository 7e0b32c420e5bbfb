"""The ``flow_query`` loop: one resident pass, then ``query_flows`` of a
fresh sample of ``keys_per_query`` flows (from every path length) over
the mix's epochs, one operation a query.

The comparison takes a sample of the window's queries drawn from the
seed (``check_queries``): ``est_rel_gap``, the largest gap of an
estimate from the plain reference's, relative to the reference's
estimate or 1, whichever is larger.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from perfbench.check import sample
from perfbench.timed import Run, answers_of, draw, query_loop


def epochs_of(h):
    """The epochs every query asks about: ``"all"`` of the inputs."""
    if h.mix["epochs"] != "all":
        raise ValueError(f"unknown epochs {h.mix['epochs']!r}")
    return list(range(h.inputs.n_epochs))


def flows_of(h, i: int) -> np.ndarray:
    """Flow indices of query ``i``: ``keys_per_query`` distinct flows."""
    n = len(h.inputs.keys)
    k = min(int(h.mix["keys_per_query"]), n)
    return np.sort(draw(h.seed, i).choice(n, size=k, replace=False))


def run(h) -> Run:
    keys = h.inputs.keys
    paths = np.empty(len(keys), dtype=object)
    for j, p in enumerate(h.inputs.paths()):
        paths[j] = p
    epochs = epochs_of(h)

    def pick(i):
        idx = flows_of(h, i)
        return (keys[idx], paths[idx], epochs), epochs

    def call(system, *args):
        return np.asarray(h.sut.query_flows(system, *args), np.float64)

    return query_loop(h, "query_flows", pick, call)


def produced(h, run: Run) -> dict:
    return answers_of(run, h.sut)


def control(h, ctrl) -> dict:
    """The answers of ``ctrl`` (the reference in the control's precision)
    to the first ``check_queries`` queries."""
    epochs = epochs_of(h)
    ctrl.ingest(h.inputs.streams, keep=epochs)
    qs = range(int(h.mix["check_queries"]))
    return {"answers": {i: ctrl.estimates(*_asked(h, i, epochs)) for i in qs},
            "query_epochs": {i: epochs for i in qs}}


def _asked(h, i, epochs):
    idx = flows_of(h, i)
    return h.inputs.keys[idx], h.inputs.path_mat[idx], epochs


def compare(h, out: dict, ref_mod) -> Tuple[dict, dict]:
    picked = sample(h.seed, list(out["answers"]), int(h.mix["check_queries"]))
    ref = ref_mod.Reference(h.cfg)
    ref.ingest(h.inputs.streams,
               keep={e for i in picked for e in out["query_epochs"][i]})
    gap = 0.0
    for i in picked:
        want = ref.estimates(*_asked(h, i, out["query_epochs"][i]))
        got = np.asarray(out["answers"][i], np.float64)
        if got.shape != want.shape:
            return {"est_rel_gap": math.inf}, {}
        g = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
        gap = max(gap, float(np.max(g, initial=0.0)))
    return {"est_rel_gap": gap if math.isfinite(gap) else math.inf}, {}
