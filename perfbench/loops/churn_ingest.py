"""The ``churn_ingest`` loop: the ``ingest`` loop's passes, each under the
configuration's failure schedule (the adapter feeds each window its
events and rebuilds what parity can after the last window), one
operation a pass.

The comparison takes the window's last pass, against the plain reference
``disketch_churn.py``: ``counter_mismatch``, the counters of every
(epoch, fragment) cell that differ (a cell missing or of another shape
counts whole), plus the entries of the Eq. 6 trajectory (``n_log``) that
differ; ``peb_rel_gap``, the largest relative gap of a PEB, a PEB present
where the reference has none or missing where it has one counting as
inf; ``liveness_mismatch``, the (epoch, switch) cells whose liveness
differs; and ``est_rel_gap``, the largest gap of an estimate over
max(reference, 1) in the mix's queries, each ``query_flows(merge=
"fragment", failures="recover")`` of ``keys_per_query`` flows drawn from
the seed over one span of epochs, asked of the state the pass left.  A
flow whose path no queried epoch can observe is left out of that query.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from perfbench.loops import ingest

run = ingest.run


def query_epochs(h, spec: str) -> List[int]:
    """``"all"`` epochs of the inputs, or ``"death_window"``: the dispatch
    window that holds the schedule's first death."""
    n_epochs, size = h.inputs.n_epochs, int(h.cfg["window"])
    if spec == "all":
        return list(range(n_epochs))
    if spec == "death_window":
        first = min(int(d) for d, _ in h.cfg["failures"]["downs"].values())
        e0 = first // size * size
        return list(range(e0, min(e0 + size, n_epochs)))
    raise ValueError(f"unknown query epochs {spec!r}")


def queries(h, ref_mod) -> List[Tuple[np.ndarray, List[int]]]:
    """The mix's queries: ``(flow indices, epochs)`` each."""
    n = len(h.inputs.keys)
    k = min(int(h.mix["keys_per_query"]), n)
    idx = np.sort(np.random.default_rng([h.seed, 0xC4]).choice(
        n, size=k, replace=False))
    live = ref_mod.liveness(h.cfg, h.inputs.n_epochs)
    pm = h.inputs.path_mat[idx]
    out = []
    for spec in h.mix["query_epochs"]:
        epochs = query_epochs(h, spec)
        seen = np.zeros(len(idx), bool)
        for e in epochs:
            seen |= ((pm >= 0) & live[e][np.maximum(pm, 0)]).any(axis=1)
        out.append((idx[seen], epochs))
    return out


def produced(h, run) -> dict:
    """``ingest``'s outputs of the last pass, each cell's liveness and the
    answers to the mix's queries; the program's state is dropped."""
    system, sut = run.system, h.sut
    live, answers = {}, []
    if system is not None:
        live = {(e, sw): sut.is_live(system, e, sw)
                for e in range(h.inputs.n_epochs) for sw in sut.order}
        paths = np.empty(len(h.inputs.keys), dtype=object)
        for j, path in enumerate(h.inputs.paths()):
            paths[j] = path
        for idx, epochs in queries(h, h.reference):
            try:
                answers.append(np.asarray(sut.query_flows(
                    system, h.inputs.keys[idx], paths[idx], epochs),
                    np.float64))
            except Exception as exc:    # an answer that never came
                answers.append(f"{type(exc).__name__}: {exc}")
    out = ingest.produced(h, run)
    out.update(live=live, answers=answers)
    return out


def control(h, ctrl) -> dict:
    """The same outputs from ``ctrl``, the reference in the control's
    precision, put in the program's place."""
    ctrl.ingest(h.inputs.streams)
    live = {(e, f): bool(ctrl.live[e, f])
            for e in range(h.inputs.n_epochs) for f in range(ctrl.n_frags)}
    answers = [ctrl.estimates(h.inputs.keys[idx], h.inputs.path_mat[idx],
                              epochs)
               for idx, epochs in queries(h, h.reference)]
    return {"cells": ctrl.counters, "n_log": ctrl.n_log, "pebs": ctrl.pebs,
            "live": live, "answers": answers}


def compare(h, out: dict, ref_mod) -> Tuple[dict, dict]:
    ref = ref_mod.Reference(h.cfg)
    ref.ingest(h.inputs.streams)
    numbers = {"counter_mismatch": 0, "peb_rel_gap": 0.0,
               "liveness_mismatch": 0, "est_rel_gap": 0.0}
    for key, r in ref.counters.items():
        p = out["cells"].get(key)
        if p is None or np.shape(p) != r.shape:
            numbers["counter_mismatch"] += max(r.size, np.size(p))
        else:
            numbers["counter_mismatch"] += int(np.count_nonzero(
                np.asarray(p, np.float64) != r))
    for e, want in enumerate(ref.n_log):
        got = out["n_log"][e] if e < len(out["n_log"]) else {}
        numbers["counter_mismatch"] += sum(
            1 for f, n in enumerate(want) if ingest._get(got, f) != n)
    for e, want in enumerate(ref.pebs):
        got = out["pebs"][e] if e < len(out["pebs"]) else {}
        for f, r in enumerate(want):
            p = ingest._get(got, f)
            if (p is None) != (r is None):
                gap = math.inf
            else:
                gap = 0.0 if r is None else abs(p - r) / max(abs(r), 1e-30)
            numbers["peb_rel_gap"] = max(numbers["peb_rel_gap"], gap)
    numbers["liveness_mismatch"] = sum(
        1 for e in range(h.inputs.n_epochs) for f in range(ref.n_frags)
        if out["live"].get((e, f)) != bool(ref.live[e, f]))
    asked = queries(h, ref_mod)
    for j, (idx, epochs) in enumerate(asked):
        want = ref.estimates(h.inputs.keys[idx], h.inputs.path_mat[idx],
                             epochs)
        got = out["answers"][j] if j < len(out["answers"]) else None
        if not isinstance(got, np.ndarray) or got.shape != want.shape:
            numbers["est_rel_gap"] = math.inf
            continue
        g = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0),
                         initial=0.0))
        numbers["est_rel_gap"] = max(numbers["est_rel_gap"],
                                     math.inf if math.isnan(g) else g)
    return numbers, {}
