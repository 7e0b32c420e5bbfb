"""Spans inside the program: where a call's host time goes.

``span(name, **counts)`` times one step of a call on the host clock
(``time.perf_counter_ns``)::

    with obs.span("fleet.upload"):
        ...
        obs.add("bytes", n)

Each closed span is kept as a record with ``id``, ``parent`` (the
innermost span open around it on the same thread, or None), ``root``
(the outermost one: every span of one call into the program shares it),
``name``, ``start_ns``, ``end_ns`` and ``counts`` (a dict, or None).
``add(key, n)`` adds ``n`` to a count of the innermost open span.

The records go to a bounded buffer, the newest ``CAPACITY`` kept and the
older ones counted in ``dropped()``: an operator's flight recorder.
``spans()`` lists it, ``dump(path)`` writes it as JSON lines and
``clear()`` empties it.  The recorder is on from import; ``enable(False)``
makes ``span`` return one shared null context that records nothing.

While a ``torch.profiler`` runs, each span also opens a
``torch.profiler.record_function`` range of its name, so the steps lie on
the profiler's timeline beside the kernels and copies they launch.
"""
from __future__ import annotations

import itertools
import json
import threading
from collections import deque
from time import perf_counter_ns
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

#: Records the buffer keeps (the newest).
CAPACITY = 2 ** 18


class _Open(threading.local):
    def __init__(self):
        self.stack: List["Span"] = []


_open = _Open()
_ids = itertools.count(1)
_buf: deque = deque(maxlen=CAPACITY)
_state = {"on": True, "dropped": 0}


class Span:
    """One timed step; a context manager, and once closed its record."""

    __slots__ = ("id", "parent", "root", "name", "start_ns", "end_ns",
                 "counts", "_rf")

    def __init__(self, name: str, counts: Optional[Dict[str, int]]):
        self.name = name
        self.counts = counts
        self.end_ns = None

    def __enter__(self) -> "Span":
        stack = _open.stack
        self.id = next(_ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[0].id
        else:
            self.parent, self.root = None, self.id
        stack.append(self)
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        _open.stack.pop()
        if len(_buf) == CAPACITY:
            _state["dropped"] += 1
        _buf.append(self)
        return False

    def as_dict(self) -> dict:
        return {"id": self.id, "parent": self.parent, "root": self.root,
                "name": self.name, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "counts": self.counts}


class _Null:
    """What ``span`` returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _Null()


def span(name: str, **counts: int):
    """A context manager timing one step called ``name``, with initial
    ``counts``; the null context while the recorder is off."""
    if not _state["on"]:
        return _NULL
    return Span(name, counts or None)


def add(key: str, n: int) -> None:
    """Add ``n`` to count ``key`` of the innermost open span (none open:
    nothing)."""
    stack = _open.stack
    if stack:
        top = stack[-1]
        if top.counts is None:
            top.counts = {}
        top.counts[key] = top.counts.get(key, 0) + n


def enable(on: bool = True) -> None:
    """Turn the recorder on or off (it starts on)."""
    _state["on"] = bool(on)


def spans() -> List[Span]:
    """The closed spans in the buffer, oldest first."""
    return list(_buf)


def dropped() -> int:
    """Records dropped from the full buffer since the last ``clear()``."""
    return _state["dropped"]


def clear() -> None:
    _buf.clear()
    _state["dropped"] = 0


def dump(path: str) -> int:
    """Write the buffer to ``path`` as JSON lines; returns the lines."""
    recs = spans()
    with open(path, "w") as fh:
        for s in recs:
            fh.write(json.dumps(s.as_dict()) + "\n")
    return len(recs)
