"""Plain numpy reference of the DiSketch fleet at the §6.1 setting under
§6 churn: a switch's sketch memory is reclaimed for a span of epochs while
the switch keeps forwarding.

It builds on ``disketch.py`` (the update, the PEBs, Eq. 6 and the fragment
merge) and, like it, imports nothing of the program.  From the
configuration's ``failures`` (``downs[switch] = [down, up]``, ``up`` null
for never) and ``parity_group`` alone it states what a pass leaves:

* detection: a switch is found dead at its down epoch and back at its up
  epoch; the deaths of one epoch are taken one at a time in switch order,
  then its rejoins;
* a window's n are frozen at its start, once the events of its first
  epoch are in; the events of its later epochs change the controller's n
  for the next window;
* a *dead* cell (the switch down in that epoch) counts nothing: its
  counters are zeros at the window's n, it has no PEB, and it takes no
  part in Eq. 6 or in a query;
* a *lost* cell is a victim's epoch before its death in the same window:
  it sketched the epoch, so its PEB stands and enters Eq. 6, but the
  reclaimed memory held its counters, so they are zeros and the cell is
  masked.  Where it is the only lost cell of its parity group (a chunk of
  ``parity_group`` switches in switch order) in that epoch, the controller
  rebuilds it at the pass's end: it then holds the counters it had before
  the loss, and it is live;
* each death re-equalizes (§6) every switch not dead by then that has a
  PEB from an earlier window: its n jumps to the fixed point of Eq. 6
  against its last PEB, the PEB at n' predicted as ``peb * n / n'``.  Five
  deaths of one epoch do so five times;
* a rejoined switch restarts at n = 1 in the controller; in the rest of
  the window of its rejoin it counts at the window's n;
* the fragment merge masks: per epoch the median over a key's live
  on-path fragments; an epoch with none is blind, and the window's sum is
  scaled by E / E_observable of the key's path.

``precision="bf16"`` is the control, as in ``disketch.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from .disketch import Fleet


@dataclass
class Window:
    """One dispatch window of the schedule: its epochs, the events found
    at each epoch's start (``("fail" | "recover", switch)``), and the
    switches dead and lost in each epoch."""

    epochs: List[int]
    events: List[List[Tuple[str, int]]]
    dead: List[Set[int]]
    lost: List[Set[int]]


def downs_of(cfg: dict) -> Dict[int, Tuple[int, Optional[int]]]:
    """``{switch: (down, up)}`` of the configuration's ``failures``."""
    out = {}
    for sw, (d, u) in cfg["failures"]["downs"].items():
        d, u = int(d), None if u is None else int(u)
        if d < 1 or (u is not None and u <= d):
            # a heartbeat monitor finds no death before epoch 1
            raise ValueError(f"switch {sw}: down {d}, up {u}")
        out[int(sw)] = (d, u)
    return out


def windows(cfg: dict, n_epochs: int) -> List[Window]:
    """The schedule as the dispatch windows of ``n_epochs`` epochs."""
    downs, size = downs_of(cfg), int(cfg["window"])
    dead: Set[int] = set()
    out = []
    for e0 in range(0, n_epochs, size):
        w = Window(list(range(e0, min(e0 + size, n_epochs))), [], [], [])
        deaths = []
        for k, e in enumerate(w.epochs):
            evs = ([("fail", sw) for sw in sorted(downs)
                    if downs[sw][0] == e]
                   + [("recover", sw) for sw in sorted(downs)
                      if downs[sw][1] == e])
            for kind, sw in evs:
                if kind == "fail":
                    deaths.append((k, sw))
                    dead.add(sw)
                else:
                    dead.discard(sw)
            w.events.append(evs)
            w.dead.append(set(dead))
        w.lost = [{sw for k, sw in deaths if j < k and sw not in w.dead[j]}
                  for j in range(len(w.epochs))]
        out.append(w)
    return out


def liveness(cfg: dict, n_epochs: int) -> np.ndarray:
    """``(n_epochs, n_frags)`` bool: the cells a query may use after a
    pass, neither dead nor lost (or lost and rebuilt from parity)."""
    n_frags = len(cfg["memories_bytes"])
    size = int(cfg["parity_group"])
    live = np.ones((n_epochs, n_frags), bool)
    for w in windows(cfg, n_epochs):
        for e, dead, lost in zip(w.epochs, w.dead, w.lost):
            for sw in dead:
                live[e, sw] = False
            for sw in lost:
                mates = {sw - sw % size + j for j in range(size)} - {sw}
                live[e, sw] = not (mates & lost)
    return live


class ChurnFleet(Fleet):
    """``disketch.Fleet`` under the configuration's failure schedule."""

    def __init__(self, cfg: dict, precision: str = "exact"):
        super().__init__(cfg, precision)
        self.cfg = cfg
        #: filled by ingest: (n_epochs, n_frags) bool cells a query uses
        self.live: Optional[np.ndarray] = None
        #: pebs[e][f]: None for a dead cell
        self.pebs: List[List[Optional[float]]] = []

    def converge(self, n: int, peb: float) -> int:
        """§6: Eq. 6 iterated to its fixed point from ``n``, the PEB at
        n' predicted as ``peb * n / n'``."""
        if peb <= 0.0 or not math.isfinite(peb):
            return n
        n0 = n
        while True:
            nn = self.next_n(n, peb * n0 / n)
            if nn == n:
                return n
            n = nn

    def ingest(self, streams: Sequence[dict],
               keep: Optional[Iterable[int]] = None,
               on_window=None) -> None:
        """One pass as ``Fleet.ingest``, under the schedule; the cells lost
        and rebuilt from parity hold their counters from the start."""
        n_epochs = len(streams)
        keep = set(range(n_epochs) if keep is None else keep)
        self.live = liveness(self.cfg, n_epochs)
        ns = [1] * self.n_frags
        dead: Set[int] = set()
        last: Dict[int, float] = {}          # each switch's last PEB

        def apply(events):
            for kind, sw in events:
                if kind == "fail":
                    dead.add(sw)
                    for f in range(self.n_frags):
                        if f not in dead and f in last:
                            ns[f] = self.converge(ns[f], last[f])
                else:
                    dead.discard(sw)
                    ns[sw] = 1

        empty = (np.zeros(0, np.uint32), np.zeros(0, np.int64))
        for w in windows(self.cfg, n_epochs):
            apply(w.events[0])
            frozen = list(ns)
            for events in w.events[1:]:
                apply(events)
            window_pebs = []
            for k, e in enumerate(w.epochs):
                pebs: List[Optional[float]] = [None] * self.n_frags
                levels = self.L if e in keep else 1
                for f in range(self.n_frags):
                    n = frozen[f]
                    if f in w.dead[k]:
                        c = np.zeros((levels, n, self.widths[f]), np.int64)
                    else:
                        keys, ts = streams[e].get(f, empty)[:2]
                        c = self._round(self.cell(
                            f, e, n, np.asarray(keys, np.uint32),
                            np.asarray(ts, np.int64), levels))
                        pebs[f] = self.peb(c[0])
                        if not self.live[e, f]:       # lost for good
                            c = np.zeros_like(c)
                    self.n_at[(e, f)] = n
                    if e in keep:
                        self.counters[(e, f)] = c
                window_pebs.append(pebs)
            for pebs in window_pebs:                  # Eq. 6 in order
                for f, p in enumerate(pebs):
                    if p is not None:
                        ns[f] = self.next_n(ns[f], p)
                        last[f] = p
                self.pebs.append(pebs)
                self.n_log.append(list(ns))
            if on_window is not None:
                on_window(w.epochs)

    def estimates(self, keys: np.ndarray, path_mat: np.ndarray,
                  epochs: Sequence[int], level: int = 0) -> np.ndarray:
        """The masked fragment merge: ``Fleet.estimates`` epoch by epoch
        over each key's live on-path fragments, blind epochs adding
        nothing, the sum scaled by E / E_observable of the key's path.
        Raises ``ValueError`` for a path with no observable epoch."""
        out = np.zeros(len(keys))
        seen = np.zeros(len(keys), np.int64)
        for e in epochs:
            live = (path_mat >= 0) & self.live[e][np.maximum(path_mat, 0)]
            out = self._round(out + super().estimates(
                keys, np.where(live, path_mat, -1), [e], level))
            seen += live.any(axis=1)
        if not seen.all():
            raise ValueError("a key's path has no live fragment in any "
                             "queried epoch")
        return self._round(out * (len(epochs) / seen))


Reference = ChurnFleet
