"""Sketch fragments: configuration, seeds and records (port of the parts of
``repro/core/fragment.py`` the fleet path needs).

A fragment is one sketch row (per UnivMon level) hosted at one switch,
sized to that switch's residual memory; its hash seeds derive from
``(frag_id, epoch, role)`` so the query plane can recompute every hash.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

_ROLE_COL, _ROLE_SIGN, _ROLE_SUB = 0x1000, 0x2000, 0x3000


def frag_seed(frag_id: int, epoch: int, role: int, base_seed: int = 0) -> int:
    return int((frag_id * 1_000_003 + epoch * 7919 + role + base_seed)
               & 0x7FFFFFFF)


@dataclass
class FragmentConfig:
    frag_id: int
    kind: str                 # "cs" | "cms" | "um"
    memory_bytes: int
    counter_bytes: int = 4
    n_levels: int = 16        # UnivMon only
    level_seed: int = 7777    # network-wide (must match across fragments)
    mitigation: bool = False  # §4.4 single-hop enhancement
    base_seed: int = 0

    @property
    def width(self) -> int:
        w = self.memory_bytes // self.counter_bytes
        if self.kind == "um":
            w = w // self.n_levels
        return max(int(w), 4)


@dataclass
class EpochRecords:
    """All subepoch records of one fragment for one epoch: ``counters[s]``
    is subepoch ``s``'s row, ``(n, w)`` or ``(L, n, w)`` for UnivMon."""

    frag_id: int
    epoch: int
    n: int
    counters: np.ndarray
    kind: str
    mitigation: bool
    base_seed: int = 0

    def seeds(self) -> Tuple[int, int, int]:
        return (
            frag_seed(self.frag_id, self.epoch, _ROLE_COL, self.base_seed),
            frag_seed(self.frag_id, self.epoch, _ROLE_SIGN, self.base_seed),
            frag_seed(self.frag_id, self.epoch, _ROLE_SUB, self.base_seed),
        )

    @property
    def width(self) -> int:
        return int(self.counters.shape[-1])


def level_seed_mix(seed: int, level: int) -> int:
    """Per-UnivMon-level seed derivation (levels = independent CS rows)."""
    return int((seed ^ (level * 0x9E3779B9)) & 0x7FFFFFFF)
