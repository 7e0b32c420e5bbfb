"""Sketch fragments: configuration, seeds, records and the host numpy
update (port of ``repro/core/fragment.py``).

A fragment is one sketch row (per UnivMon level) hosted at one switch,
sized to that switch's residual memory; its hash seeds derive from
``(frag_id, epoch, role)`` so the query plane can recompute every hash.
``process_epoch`` is the per-switch numpy update of the ``loop`` backend;
``CumulativeFragment`` is the §5 export without counter resets.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from . import hashing as H

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


def packet_subepoch(ts: np.ndarray, epoch_start: int, log2_te: int,
                    n: int) -> np.ndarray:
    """Method 2 (§5): subepoch id = bit-slice T[log2(Te) : log2(Tf)] of the
    *global* timestamp (epochs start at multiples of Te, so no subtraction
    is needed)."""
    del epoch_start  # kept for the reference's signature; Method 2 ignores it
    shift = log2_te - int(np.log2(n))
    return ((np.asarray(ts, dtype=np.int64) >> shift) & (n - 1)).astype(
        np.int32)


def monitored_mask(keys: np.ndarray, sub_pkt: np.ndarray, sub_seed: int,
                   n: int, single_hop: Optional[np.ndarray],
                   mitigation: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Which packets this fragment monitors, per §4.1 (+§4.4).  Returns
    ``(mask, flow_subepoch)``."""
    sub_flow = H.hash_pow2(np.asarray(keys, dtype=np.uint32), sub_seed, n)
    mask = sub_pkt == sub_flow
    if mitigation and n >= 2 and single_hop is not None:
        sub2 = (sub_flow + n // 2) & (n - 1)
        mask = mask | (single_hop & (sub_pkt == sub2))
    return mask, sub_flow


def process_epoch(cfg: FragmentConfig, epoch: int, n: int,
                  keys: np.ndarray, values: np.ndarray, ts: np.ndarray,
                  epoch_start: int, log2_te: int,
                  single_hop: Optional[np.ndarray] = None) -> EpochRecords:
    """One epoch of online sketching for one fragment on the host (the
    ``loop`` backend): the fragment's full set of subepoch records."""
    w = cfg.width
    keys = np.asarray(keys, dtype=np.uint32)
    values = np.asarray(values, dtype=np.int64)
    col_seed, sign_seed, sub_seed = (
        frag_seed(cfg.frag_id, epoch, _ROLE_COL, cfg.base_seed),
        frag_seed(cfg.frag_id, epoch, _ROLE_SIGN, cfg.base_seed),
        frag_seed(cfg.frag_id, epoch, _ROLE_SUB, cfg.base_seed),
    )
    sub_pkt = packet_subepoch(ts, epoch_start, log2_te, n)
    mask, _ = monitored_mask(keys, sub_pkt, sub_seed, n, single_hop,
                             cfg.mitigation)

    k, v, s = keys[mask], values[mask], sub_pkt[mask]
    if cfg.kind == "um":
        # Each level is an independent Count Sketch row (own column/sign
        # hashes) sharing the fragment's subepoch hash, per §4.2.
        lvl = H.level_of(k, cfg.level_seed, cfg.n_levels)
        counters = np.zeros((cfg.n_levels, n, w), dtype=np.int64)
        for l in range(cfg.n_levels):
            m = lvl >= l
            if not m.any():
                continue
            col_l = H.hash_mod(k[m], level_seed_mix(col_seed, l), w)
            sgn_l = H.hash_sign(k[m], level_seed_mix(sign_seed, l))
            flat = s[m].astype(np.int64) * w + col_l
            counters[l] = np.bincount(
                flat, weights=(v[m] * sgn_l).astype(np.float64),
                minlength=n * w).astype(np.int64).reshape(n, w)
    else:
        col = H.hash_mod(k, col_seed, w)
        if cfg.kind == "cs":
            v = v * H.hash_sign(k, sign_seed).astype(np.int64)
        flat = s.astype(np.int64) * w + col
        counters = np.bincount(flat, weights=v.astype(np.float64),
                               minlength=n * w).astype(np.int64).reshape(n, w)

    return EpochRecords(cfg.frag_id, epoch, n, counters, cfg.kind,
                        cfg.mitigation, cfg.base_seed)


class CumulativeFragment:
    """The §5 memory-efficient export: counters are *not* reset at
    subepoch boundaries, and the controller rebuilds each subepoch record
    as the difference of consecutive cumulative exports.  One counter
    array lives in SRAM instead of the double-buffered pair, at the cost
    of shipping cumulative snapshots; ``export_epoch``'s deltas are
    exactly the reset-mode ``EpochRecords``."""

    def __init__(self, cfg: FragmentConfig):
        self.cfg = cfg
        self._cum: Optional[np.ndarray] = None

    def export_epoch(self, epoch: int, n: int, keys, values, ts,
                     epoch_start: int, log2_te: int,
                     single_hop=None) -> EpochRecords:
        """Process one epoch without resetting; return the delta records."""
        rec = process_epoch(self.cfg, epoch, n, keys, values, ts,
                            epoch_start, log2_te, single_hop=single_hop)
        # the switch's cumulative snapshots: a running sum of every
        # subepoch so far, carried over from the previous epoch
        flat = rec.counters.reshape(-1, rec.counters.shape[-1])
        if self._cum is None or self._cum.shape != flat[0].shape:
            self._cum = np.zeros_like(flat[0])
        cum_snapshots = np.cumsum(flat, axis=0) + self._cum
        self._cum = cum_snapshots[-1].copy()
        # the controller's delta reconstruction
        deltas = np.diff(np.concatenate(
            [(cum_snapshots[0] - flat[0])[None], cum_snapshots], axis=0),
            axis=0)
        return EpochRecords(rec.frag_id, rec.epoch, rec.n,
                            deltas.reshape(rec.counters.shape), rec.kind,
                            rec.mitigation, rec.base_seed)
