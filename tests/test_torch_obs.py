"""The port's span recorder (``repro_torch.obs``) and the spans the program
records in its window path and its two device query planes.

First the recorder alone: parent and root ids, counts on the innermost
span, an exception closing its span, the bounded buffer, ``enable``, and
the ``record_function`` ranges a ``torch.profiler`` sees only while it
runs.  Then a tiny UnivMon fleet on the CPU: one ``run_window`` emits every
step span of the window path, with one PEB read a row group and epoch, one
peak read, one staging and one scatter a row group (the scatter's plain
version, which launches nothing and folds every packet's level), and the
bytes its uploads count equal to those of the staged window, the row
tables, and each group's parameter table and ``pack_csr``'s block map;
``query_flows`` and ``query_entropy`` emit the query planes' spans and the
entropy root counts its path groups.
Under churn a window also masks, takes parity and zeroes its lost cells,
each event is spanned with the survivors it re-equalized, and a recovery
counts its cells; a window without churn opens none of these spans.
"""
import json
from collections import Counter, deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import equalize, query
from repro_torch.core.disketch import DiSketchSystem
from repro_torch.core.fleet import build_params, pack_csr, pack_streams
from repro_torch.kernels.sketch_update import fleet as FK
from repro_torch.net.simulator import Replayer
from repro_torch.net.topology import FatTree
from repro_torch.net.traffic import gen_workload
from torch_threads import one_thread  # noqa: F401

LOG2_TE = 12
WINDOW = 4
N_LEVELS = 4

INGEST = ("disketch.run_window", "fleet.mass_check", "fleet.build_params",
          "fleet.fold_flags", "fleet.pack_csr", "fleet.upload",
          "fleet.peak.wait", "fleet.pebs", "fleet.pebs.wait",
          "disketch.observe")
QUERY = ("query.path_groups", "fleet.liveness", "query.stage",
         "query.gather", "query.estimates.wait")


@pytest.fixture(autouse=True)
def recorder():
    obs.enable(True)
    obs.clear()
    yield
    obs.enable(True)
    obs.clear()


def test_parent_root_and_counts_on_the_innermost_span():
    with obs.span("a") as a:
        with obs.span("b", n=1) as b:
            obs.add("n", 2)
            with obs.span("c") as c:
                pass
        obs.add("k", 5)
    with obs.span("d") as d:
        pass
    assert [s.name for s in obs.spans()] == ["c", "b", "a", "d"]
    assert (a.parent, a.root) == (None, a.id)
    assert (b.parent, b.root) == (a.id, a.id)
    assert (c.parent, c.root) == (b.id, a.id)
    assert (d.parent, d.root) == (None, d.id) and d.id > a.id
    assert a.counts == {"k": 5} and b.counts == {"n": 3}
    assert c.counts is None
    assert (a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns
            <= a.end_ns <= d.start_ns)
    assert obs.spans()[1].as_dict() == {
        "id": b.id, "parent": a.id, "root": a.id, "name": "b",
        "start_ns": b.start_ns, "end_ns": b.end_ns, "counts": {"n": 3}}


def test_add_outside_any_span_counts_nothing():
    obs.add("bytes", 4)
    with obs.span("a") as a:
        pass
    assert a.counts is None


def test_an_exception_closes_its_spans():
    with pytest.raises(ValueError, match="inside"):
        with obs.span("outer"):
            with obs.span("inner"):
                raise ValueError("inside")
    inner, outer = obs.spans()
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.end_ns is not None and outer.end_ns >= inner.end_ns
    with obs.span("next") as nxt:       # nothing left open
        pass
    assert nxt.parent is None and nxt.root == nxt.id


def test_the_buffer_keeps_the_newest_and_counts_the_dropped(monkeypatch,
                                                             tmp_path):
    assert obs.CAPACITY == 2 ** 18 and obs._buf.maxlen == obs.CAPACITY
    monkeypatch.setattr(obs, "CAPACITY", 4)
    monkeypatch.setattr(obs, "_buf", deque(maxlen=4))
    for i in range(7):
        with obs.span(f"s{i}"):
            pass
    assert [s.name for s in obs.spans()] == ["s3", "s4", "s5", "s6"]
    assert obs.dropped() == 3
    path = tmp_path / "spans.jsonl"
    assert obs.dump(str(path)) == 4
    lines = path.read_text().splitlines()
    assert [json.loads(x)["name"] for x in lines] == [
        "s3", "s4", "s5", "s6"]
    obs.clear()
    assert obs.spans() == [] and obs.dropped() == 0


def test_disabled_records_nothing():
    obs.enable(False)
    with obs.span("a", n=1) as a:
        obs.add("n", 1)
        with obs.span("b") as b:
            pass
    assert a is b                        # the one shared null context
    assert obs.spans() == []
    obs.enable(True)
    with obs.span("c"):
        pass
    assert [s.name for s in obs.spans()] == ["c"]


def test_record_function_ranges_only_while_the_profiler_runs(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with obs.span("step.before"):
        torch.ones(4).add_(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("step.inside"):
            with obs.span("step.nested"):
                torch.ones(4).add_(1)
    with obs.span("step.after"):
        torch.ones(4).add_(1)
    assert opened == ["step.inside", "step.nested"]
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "step.inside" in names and "step.nested" in names
    assert "step.before" not in names and "step.after" not in names
    assert [s.name for s in obs.spans()] == [
        "step.before", "step.nested", "step.inside", "step.after"]


# -- the program's spans ---------------------------------------------------


@pytest.fixture(scope="module")
def fleet_run():
    """A UnivMon fleet of 20 switches with three subepoch counts, one window
    dispatched; the streams, packets and ``ns`` it ran at."""
    wl = gen_workload(FatTree(4), n_flows=1500, total_packets=20_000,
                      n_epochs=WINDOW, log2_te=LOG2_TE, burstiness=0.2,
                      seed=11)
    rep = Replayer(wl, 20)
    mems = {sw: 32 * 1024 for sw in range(20)}
    system = DiSketchSystem(mems, "um", rho_target=4.0, log2_te=LOG2_TE,
                            n_levels=N_LEVELS, device="cpu")
    for sw in range(20):
        system.ns[sw] = (1, 2, 4)[sw % 3]
    ns = dict(system.ns)
    order = system.fleet.frag_order
    streams = [rep.epoch_stream(e) for e in range(WINDOW)]
    packets = [rep.epoch_packet(e, order) for e in range(WINDOW)]
    obs.clear()
    system.run_window(0, streams, packets=packets)
    recs = obs.spans()
    return wl, system, ns, streams, recs


def test_run_window_emits_every_step_span(fleet_run):
    _, system, ns, streams, recs = fleet_run
    names = Counter(s.name for s in recs)
    assert set(INGEST) <= set(names)
    root = [s for s in recs if s.parent is None]
    assert [s.name for s in root] == ["disketch.run_window"]
    assert all(s.root == root[0].id for s in recs)
    groups = system.fleet._window_bufs[0][0].device()
    assert len(groups) == len(set(ns.values())) == 3
    assert names["fleet.pebs.wait"] == len(groups) * WINDOW
    assert names["fleet.peak.wait"] == 1
    assert names["fleet.pack_csr"] == names["fleet.upload"] \
        == 1 + len(groups)
    assert names["fleet.fold_flags"] == 1
    scatters = [s.counts for s in recs if s.name == "fleet.pack_csr"
                and "launches" in (s.counts or {})]
    assert len(scatters) == len(groups)
    assert all(c["launches"] == 0 for c in scatters)
    assert sum(c["folded"] for c in scatters) \
        == sum(int(st.keys.shape[0]) for e in streams
               for st in e.values() if st is not None)
    pebs = next(s for s in recs if s.name == "fleet.pebs")
    assert all(s.parent == pebs.id for s in recs
               if s.name == "fleet.pebs.wait")


def test_upload_bytes_are_those_of_the_packed_stream_and_params(fleet_run):
    _, system, ns, streams, recs = fleet_run
    order = system.fleet.frag_order
    packets = [pack_streams(st, order) for st in streams]
    want = 3 * 4 * sum(len(p.keys) for p in packets)   # the staged window
    for n_g in sorted(set(ns.values())):
        idx = np.flatnonzero([ns[sw] == n_g for sw in order])
        bf = pack_csr([p.select(idx) for p in packets], system.fleet.blk)[3]
        params = np.concatenate([
            build_params(system.fragments, e, ns, order)
            for e in range(WINDOW)]).reshape(WINDOW, len(order), N_LEVELS,
                                             FK.N_PARAMS)[:, idx]
        # the int64 row table (source offset, length, first block of each
        # packet row) and block map, then the group's params and block map
        want += 8 * (3 * WINDOW * len(idx) + len(bf))
        want += params.nbytes + bf.nbytes
    got = sum(s.counts["bytes"] for s in recs if s.name == "fleet.upload")
    assert got == want


def test_query_planes_emit_their_spans(fleet_run):
    wl, system, _, _, _ = fleet_run
    epochs = list(range(WINDOW))
    obs.clear()
    system.query_flows(wl.keys, wl.paths, epochs, merge="fragment")
    flows = obs.spans()
    roots = [s for s in flows if s.parent is None]
    assert [s.name for s in roots] == ["disketch.query_flows"]
    assert set(QUERY) <= {s.name for s in flows}
    assert all(s.root == roots[0].id for s in flows)

    obs.clear()
    system.query_entropy(wl.keys, wl.paths, epochs,
                         float(wl.sizes.sum()), n_levels=N_LEVELS,
                         merge="fragment")
    ent = obs.spans()
    names = Counter(s.name for s in ent)
    roots = [s for s in ent if s.parent is None]
    assert [s.name for s in roots] == ["disketch.query_entropy"]
    n_groups = len(query.path_groups(wl.paths))
    assert roots[0].counts == {"path_groups": n_groups}
    assert set(QUERY) | {"hash.level_of", "query.gsum",
                         "query.gsum.wait"} <= set(names)
    assert (names["hash.level_of"] == names["query.estimates.wait"]
            == names["fleet.liveness"] == n_groups)
    gsum = next(s for s in ent if s.name == "query.gsum")
    assert next(s for s in ent if s.name == "query.gsum.wait").parent \
        == gsum.id
    staged = sum((s.counts or {}).get("bytes", 0) for s in ent
                 if s.name == "query.stage")
    assert staged > 0


def test_churn_emits_its_spans_only_where_it_runs():
    """A window with two deaths at its second epoch, under parity groups of
    5: the masking counts the dead packets, the parity its bytes, the loss
    its cells, each death the survivors it re-equalized, and the recovery
    the lone victim's cell.  The same window without churn opens none."""
    from repro_torch.core.fleet import parity_groups_chunked
    from repro_torch.net.simulator import FailureEvent

    wl = gen_workload(FatTree(4), n_flows=1500, total_packets=20_000,
                      n_epochs=WINDOW, log2_te=LOG2_TE, seed=12)
    rep = Replayer(wl, 20)
    mems = {sw: 4 * 1024 for sw in range(20)}
    streams = [rep.epoch_stream(e) for e in range(WINDOW)]
    churn = set(("fleet.mask", "fleet.parity", "fleet.lose",
                 "fleet.recover", "disketch.apply_event"))

    plain = DiSketchSystem(mems, "cs", rho_target=0.5, log2_te=LOG2_TE,
                           device="cpu")
    obs.clear()
    plain.run_window(0, streams)
    assert not churn & {s.name for s in obs.spans()}

    system = DiSketchSystem(
        mems, "cs", rho_target=0.5, log2_te=LOG2_TE, device="cpu",
        fleet_kwargs={"parity_groups": parity_groups_chunked(range(20), 5)})
    system.run_window(0, streams)              # a PEB for every switch
    events = [[], [FailureEvent(WINDOW + 1, 1, "fail"),
                   FailureEvent(WINDOW + 1, 7, "fail")]] + [[]] * (WINDOW - 2)
    last, ns, want = system._last_pebs(), dict(system.ns), []
    for dead in ({1}, {1, 7}):      # each death re-equalizes the others
        moved = equalize.reequalize(
            {sw: n for sw, n in ns.items() if sw not in dead}, last, 0.5)
        want.append(sum(1 for sw, n in moved.items() if ns[sw] != n))
        ns.update(moved)
    obs.clear()
    system.run_window(WINDOW, streams, events_by_epoch=events)
    system.fleet.recover()
    recs = obs.spans()
    by = {name: [s for s in recs if s.name == name] for name in churn}
    dead = sum(len(streams[e][sw].keys) for e in range(1, WINDOW)
               for sw in (1, 7) if sw in streams[e])
    assert [s.counts for s in by["fleet.mask"]] == [{"packets": dead}]
    parity = system.fleet._parity
    assert [s.counts for s in by["fleet.parity"]] == [{"bytes": sum(
        p.nbytes for e in range(WINDOW, 2 * WINDOW) for p in parity[e])}]
    assert [s.counts for s in by["fleet.lose"]] == [{"cells": 2}]
    assert [s.counts for s in by["disketch.apply_event"]] == [
        {"reequalized": n} for n in want]
    assert want[0] > 0
    assert [s.counts for s in by["fleet.recover"]] == [{"cells": 2}]
    assert all(s.root == by["disketch.apply_event"][0].root
               for s in by["fleet.mask"] + by["fleet.lose"])
