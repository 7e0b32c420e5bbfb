"""Error equalization (paper §4.2): PEB estimation + the n-control loop
(port of ``repro/core/equalize.py``).

Each fragment estimates its probabilistic error bound (PEB) from its own
counters (Eq. 4), averages it over the epoch's subepochs (Eq. 5), and
doubles/halves its number of subepochs for the next epoch to approach the
network-wide target (Eq. 6).  After a churn event the survivors jump to
Eq. 6's fixed point in one step (``converge_n``, ``reequalize``, §6).
"""
from __future__ import annotations

import numpy as np
import torch

from .fragment import EpochRecords

N_MAX = 1 << 10  # safety cap on subepochs (bounds record volume)


def peb_row(counters: np.ndarray, kind: str) -> float:
    """Eq. 4: estimated PEB of one subepoch record from its counters."""
    c = counters.astype(np.float64)
    w = c.shape[-1]
    if kind in ("cs", "um"):
        return float(np.sqrt((c * c).sum() / w))
    return float(np.abs(c).sum() / w)


def peb_epoch(rec: EpochRecords) -> float:
    """Eq. 5: mean estimated PEB over the epoch's subepochs."""
    counters = rec.counters
    if rec.kind == "um":
        counters = counters[0]  # level 0 sees the full stream (§4.2, UnivMon)
    return float(np.mean([peb_row(counters[s], rec.kind)
                          for s in range(rec.n)]))


def peb_fleet(stacked: np.ndarray, ns: np.ndarray, widths: np.ndarray,
              kind: str) -> np.ndarray:
    """Vectorized Eq. 4/5 over host ``(n_frags, n_sub_max, width_max)``
    counters with exact zeros outside each live ``[:ns[f], :widths[f]]``
    block, in float64."""
    c = stacked.astype(np.float64)
    n_sub_max = c.shape[1]
    w = np.asarray(widths, np.float64)[:, None]
    if kind in ("cs", "um"):
        row = np.sqrt((c * c).sum(axis=-1) / w)
    else:
        row = np.abs(c).sum(axis=-1) / w
    live = np.arange(n_sub_max)[None, :] < np.asarray(ns)[:, None]
    return (row * live).sum(axis=1) / np.asarray(ns, np.float64)


def peb_fleet_device(stacked: torch.Tensor, ns, widths,
                     kind: str) -> torch.Tensor:
    """``peb_fleet`` computed where the stacked f32 counters live, so a
    window transfers only its ``(n_rows,)`` PEB vector.  Row sums
    accumulate in float64 (the squares of counters below 2^24 are formed
    in f32), so the result tracks the float64 host path far inside the
    factor-of-two Eq. 6 thresholds."""
    dev = stacked.device
    ns = torch.as_tensor(np.asarray(ns, np.int64), device=dev)
    w = torch.as_tensor(np.asarray(widths, np.float64), device=dev)[:, None]
    if kind in ("cs", "um"):
        row = torch.sqrt((stacked * stacked).sum(dim=-1,
                                                 dtype=torch.float64) / w)
    else:
        row = stacked.abs().sum(dim=-1, dtype=torch.float64) / w
    live = torch.arange(stacked.shape[1], device=dev)[None, :] < ns[:, None]
    return (row * live).sum(dim=1) / ns.to(torch.float64)


def next_n(n: int, peb: float, rho_target: float) -> int:
    """Eq. 6: moving adjustment of the subepoch count."""
    if peb > 2.0 * rho_target:
        return min(2 * n, N_MAX)
    if peb < rho_target / 2.0:
        return max(1, n // 2)
    return n


def converge_n(n: int, peb: float, rho_target: float) -> int:
    """Eq. 6 iterated to its fixed point in one call.

    ``peb`` is measured at the current ``n``; under the §4.2 error model
    each doubling of the subepoch count halves a record's load and so its
    Eq. 4 bound, so the PEB predicted at ``n'`` is ``peb * n / n'``.  The
    [rho/2, 2 rho] band spans a factor of 4 while a step moves a factor of
    2, so the iteration cannot oscillate; a fragment already in the band
    keeps its ``n`` (the call is idempotent)."""
    if peb <= 0.0 or not np.isfinite(peb):
        return n
    n0, peb0 = n, peb
    for _ in range(2 * N_MAX.bit_length()):
        nn = next_n(n, peb0 * n0 / n, rho_target)
        if nn == n:
            return n
        n = nn
    return n


def reequalize(ns, pebs, rho_target: float):
    """§6 re-equalization after a churn event: ``converge_n`` for every
    fragment of ``ns`` ({switch: n}) against its last observed PEB
    (``pebs``); switches with no observation keep their ``n``, so the
    survivors of a fleet that failed before its first epoch stay
    bit-identical to a fleet that never failed."""
    return {sw: converge_n(n, pebs[sw], rho_target) if sw in pebs else n
            for sw, n in ns.items()}
