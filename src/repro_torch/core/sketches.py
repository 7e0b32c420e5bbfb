"""Aggregated (single-node) sketches: Count-Min, Count Sketch, UnivMon
(port of ``repro/core/sketches.py``).

The classical matrix-of-counters structures the paper disaggregates,
used as the "aggregated" evaluation baseline (§6, ``AggregatedSystem``).
All structures are functional: ``update`` returns new counters.

Counters are int64 torch tensors on an explicit device (default
``cuda``).  An update is one ``index_add_`` of every row's adds: int64
sums are exact and do not depend on the order of the adds, so the
counters equal the reference's ``np.add.at`` bit for bit.  Point queries
gather on the device in float64 and return numpy; the UnivMon G-sum runs
its top-down recursion on the host, in float64, as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from . import hashing as H


@dataclass(frozen=True)
class SketchSpec:
    """Shape/seed specification for a matrix sketch."""

    kind: str  # "cms" | "cs"
    depth: int
    width: int
    seed: int = 0

    def row_seeds(self) -> np.ndarray:
        rng = np.random.RandomState(self.seed)
        return rng.randint(0, 2**31 - 1, size=(self.depth, 2), dtype=np.int64)


def make_counters(spec: SketchSpec, device=None) -> torch.Tensor:
    return torch.zeros((spec.depth, spec.width), dtype=torch.int64,
                       device=resolve_device(device))


def _keys(keys, dev: torch.device) -> torch.Tensor:
    """uint32 keys as the int64 tensor the torch hashes take."""
    return torch.as_tensor(np.asarray(keys, np.uint32).astype(np.int64),
                           device=dev)


def update(spec: SketchSpec, counters: torch.Tensor, keys: np.ndarray,
           values: np.ndarray) -> torch.Tensor:
    """Insert a batch of (key, value) pairs into every row; returns new
    counters on ``counters``' device."""
    dev = counters.device
    seeds = spec.row_seeds()
    k = _keys(keys, dev)[None, :]                               # (1, P)
    v = torch.as_tensor(np.asarray(values, np.int64), device=dev)[None, :]
    col = H.hash_mod_torch(k, seeds[:, :1], spec.width)         # (depth, P)
    if spec.kind == "cs":
        v = v * H.hash_sign_torch(k, seeds[:, 1:])
    rows = torch.arange(spec.depth, device=dev)[:, None]
    out = counters.clone()
    out.view(-1).index_add_(0, (rows * spec.width + col).reshape(-1),
                            v.expand(spec.depth, -1).reshape(-1))
    return out


def query(spec: SketchSpec, counters: torch.Tensor,
          keys: np.ndarray) -> np.ndarray:
    """Point-query frequency estimates for ``keys`` (float64, numpy)."""
    dev = counters.device
    seeds = spec.row_seeds()
    k = _keys(keys, dev)[None, :]
    col = H.hash_mod_torch(k, seeds[:, :1], spec.width)         # (depth, K)
    ests = counters.gather(1, col).to(torch.float64)
    if spec.kind == "cs":
        ests = ests * H.hash_sign_torch(k, seeds[:, 1:]).to(torch.float64)
    if spec.kind == "cms":
        return ests.min(dim=0).values.cpu().numpy()
    srt = ests.sort(dim=0).values         # np.median: the middle pair's mean
    d = spec.depth
    return (0.5 * (srt[(d - 1) // 2] + srt[d // 2])).cpu().numpy()


# ---------------------------------------------------------------------------
# UnivMon (Liu et al., SIGCOMM'16): a stack of Count Sketch "levels", level l
# seeing a 2^-l subsample of the stream.  Supports G-sum queries (entropy,
# F2, ...) via the recursive estimator.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class UnivMonSpec:
    depth: int
    width: int          # width of every level (same width, as in the paper)
    n_levels: int = 16  # ~log2(#flows), per the paper's footnote 5
    seed: int = 0
    level_seed: int = 7777  # NETWORK-WIDE seed: level membership must agree
    #                         across fragments for composite querying.

    def level_spec(self, lvl: int) -> SketchSpec:
        return SketchSpec("cs", self.depth, self.width,
                          seed=self.seed * 131 + lvl)


def um_make_counters(spec: UnivMonSpec, device=None) -> torch.Tensor:
    return torch.zeros((spec.n_levels, spec.depth, spec.width),
                       dtype=torch.int64, device=resolve_device(device))


def um_update(spec: UnivMonSpec, counters: torch.Tensor, keys: np.ndarray,
              values: np.ndarray) -> torch.Tensor:
    keys = np.asarray(keys, dtype=np.uint32)
    values = np.asarray(values, dtype=np.int64)
    out = counters.clone()
    lvl = H.level_of(keys, spec.level_seed, spec.n_levels)
    for l in range(spec.n_levels):
        m = lvl >= l
        if not m.any():
            continue
        out[l] = update(spec.level_spec(l), out[l], keys[m], values[m])
    return out


def um_query_freq(spec: UnivMonSpec, counters: torch.Tensor,
                  keys: np.ndarray) -> np.ndarray:
    """Frequency estimate from level 0 (sees the full stream)."""
    return query(spec.level_spec(0), counters[0], keys)


def um_gsum(spec: UnivMonSpec, counters: torch.Tensor,
            candidate_keys: np.ndarray, g, k_heavy: int = 1024) -> float:
    """Recursive UnivMon G-sum estimator over the level stack.

    ``candidate_keys`` is the query key universe (in simulation, all
    observed flow keys); ``g`` maps estimated frequency -> contribution
    (numpy, e.g. x*log2(x)).
    """
    keys = np.asarray(candidate_keys, dtype=np.uint32)
    lvl = H.level_of(keys, spec.level_seed, spec.n_levels)
    y = 0.0
    for l in range(spec.n_levels - 1, -1, -1):
        sel = lvl >= l
        if not sel.any():
            y = 2.0 * y
            continue
        k_l = keys[sel]
        est = query(spec.level_spec(l), counters[l], k_l)
        est = np.maximum(est, 1.0)
        order = np.argsort(-est)[:k_heavy]
        hh_est = est[order]
        in_next = (lvl[sel][order] >= (l + 1)).astype(np.float64)
        if l == spec.n_levels - 1:
            y = float(np.sum(g(hh_est)))
        else:
            y = 2.0 * y + float(np.sum((1.0 - 2.0 * in_next) * g(hh_est)))
    return y


def um_entropy(spec: UnivMonSpec, counters: torch.Tensor,
               candidate_keys: np.ndarray, total: float,
               k_heavy: int = 1024) -> float:
    """Empirical entropy (bits): log2(m) - (1/m) * sum f_i log2 f_i."""
    s = um_gsum(spec, counters, candidate_keys,
                lambda x: x * np.log2(np.maximum(x, 1.0)), k_heavy=k_heavy)
    if total <= 0:
        return 0.0
    return float(np.log2(total) - s / total)


def true_entropy(sizes: np.ndarray) -> float:
    sizes = np.asarray(sizes, dtype=np.float64)
    sizes = sizes[sizes > 0]
    m = sizes.sum()
    p = sizes / m
    return float(-(p * np.log2(p)).sum())
