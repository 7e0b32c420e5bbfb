"""The comparison that decides ``correct``, as far as every loop shares
it: the queries a run checks, and each number beside its limit.

What a loop compares, and how, is its own (``perfbench/loops/``); the
limits are the cell's (``perfbench/limits/<cell>.json``).  The same
comparison judges the control (the reference in bfloat16), which must
come out not correct.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def sample(seed: int, done: Sequence[int], k: int) -> List[int]:
    """The queries a run checks: ``k`` of those completed, drawn from the
    seed."""
    done = sorted(done)
    if len(done) <= k:
        return done
    rng = np.random.default_rng([int(seed), 0xC0FFEE])
    return sorted(int(done[j]) for j in
                  rng.choice(len(done), size=k, replace=False))


def verdict(numbers: dict, limits: dict) -> Tuple[bool, dict]:
    """Each number beside its limit, and whether all are within."""
    shown, ok = {}, True
    for name, value in numbers.items():
        lim = float(limits[name]["limit"])
        v = float(value)
        shown[name] = {"value": v, "limit": lim}
        ok &= bool(v <= lim)          # NaN fails
    return ok, shown
