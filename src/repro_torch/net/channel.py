"""Lossy message channel over integer rounds (port of
``repro/net/channel.py``).

A ``LossyChannel`` carries small protocol messages (the control plane's
``runtime.control.ConfigDirective`` and ``ConfigAck``; anything with
``frag``/``epoch``/``seq`` attributes) and applies per-message drop,
duplication, reordering and delay drawn from a *seeded, order-independent*
RNG: a message's fate is a pure function of ``(channel seed, frag, epoch,
seq)``, so a replay that sends the same attempts, in any order, sees the
same channel.  Time is round-based (an integer ``now`` the caller
advances), which keeps the protocol deterministic and replayable, like
``net.simulator.FailureSchedule``.

Host numpy, as in the reference: the draws are taken in the reference's
order, so the same sends give the same deliveries and counters bit for
bit.
"""
from __future__ import annotations

import heapq
from typing import Any, List, Tuple

import numpy as np


def _msg_key(msg) -> Tuple[int, int, int]:
    """(frag, epoch, seq) identity of a protocol message; zeros for a
    message without the attributes (still deterministic, shared fate)."""
    return (int(getattr(msg, "frag", 0)), int(getattr(msg, "epoch", 0)),
            int(getattr(msg, "seq", 0)))


class LossyChannel:
    """Seeded drop/duplicate/reorder/delay channel over integer rounds.

    ``send(msg, now)`` schedules delivery; ``deliver(now)`` returns every
    message whose delivery round has come, in delivery order.  Each
    retransmission *attempt* (a fresh ``seq``) draws its own fate, so a
    retry is a second chance, not a replay of the first attempt's luck.

    * ``p_drop`` — probability a copy vanishes;
    * ``p_dup`` — probability a surviving copy is delivered twice;
    * ``p_reorder`` — probability a copy is held back 1-3 extra rounds
      (with a seeded tie-break within a round), so later sends overtake it;
    * ``delay`` — (min, max) inclusive base latency in rounds; a message
      sent at round t is delivered at t + 1 at the earliest.

    ``n_sent``/``n_dropped``/``n_dup``/``n_delivered`` count the traffic.
    """

    def __init__(self, p_drop: float = 0.0, p_dup: float = 0.0,
                 p_reorder: float = 0.0,
                 delay: Tuple[int, int] = (0, 0), seed: int = 0):
        for name, p in (("p_drop", p_drop), ("p_dup", p_dup),
                        ("p_reorder", p_reorder)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name}={p} not in [0, 1]")
        lo, hi = int(delay[0]), int(delay[1])
        if lo < 0 or hi < lo:
            raise ValueError(f"delay range {delay} invalid")
        self.p_drop = float(p_drop)
        self.p_dup = float(p_dup)
        self.p_reorder = float(p_reorder)
        self.delay = (lo, hi)
        self.seed = int(seed)
        # min-heap of (deliver_round, tiebreak, insertion_count, msg)
        self._q: List[Tuple[int, int, int, Any]] = []
        self._count = 0
        self.n_sent = 0
        self.n_dropped = 0
        self.n_dup = 0
        self.n_delivered = 0

    def _rng(self, msg) -> np.random.Generator:
        f, e, s = _msg_key(msg)
        return np.random.default_rng(
            np.array([self.seed, f, e, s], dtype=np.uint64))

    def send(self, msg, now: int) -> None:
        """Schedule ``msg`` (sent at round ``now``) for delivery."""
        self.n_sent += 1
        rng = self._rng(msg)
        if rng.random() < self.p_drop:
            self.n_dropped += 1
            return
        copies = 1
        if rng.random() < self.p_dup:
            copies = 2
            self.n_dup += 1
        lo, hi = self.delay
        for _ in range(copies):
            lat = 1 + int(rng.integers(lo, hi + 1))
            if rng.random() < self.p_reorder:
                lat += 1 + int(rng.integers(0, 3))
            # the seeded tie-break reorders same-round arrivals too
            tiebreak = int(rng.integers(0, 1 << 30)) \
                if self.p_reorder > 0 else self._count
            heapq.heappush(self._q, (int(now) + lat, tiebreak,
                                     self._count, msg))
            self._count += 1

    def deliver(self, now: int) -> List[Any]:
        """Pop every message due at or before round ``now``."""
        out = []
        while self._q and self._q[0][0] <= now:
            out.append(heapq.heappop(self._q)[3])
        self.n_delivered += len(out)
        return out

    def pending(self) -> int:
        """Messages scheduled but not yet delivered."""
        return len(self._q)

    def undelivered(self) -> List[Tuple[int, Any]]:
        """In-flight messages as ``(deliver_round, msg)``, soonest first,
        without consuming the queue: what a drain that stops at some round
        must count as delayed past it, not lost on the wire."""
        return [(entry[0], entry[3]) for entry in sorted(self._q)]

    def clear(self) -> int:
        """Drop every in-flight message (the receiver lost the wire);
        returns how many were lost."""
        n = len(self._q)
        self._q.clear()
        return n

    def stats(self) -> dict:
        return {"n_sent": self.n_sent, "n_dropped": self.n_dropped,
                "n_dup": self.n_dup, "n_delivered": self.n_delivered,
                "pending": self.pending()}
