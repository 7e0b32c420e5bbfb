"""Error equalization (paper §4.2): PEB estimation + the n-control loop
(port of the fleet parts of ``repro/core/equalize.py``).

Each fragment estimates its probabilistic error bound (PEB) from its own
counters (Eq. 4), averages it over the epoch's subepochs (Eq. 5), and
doubles/halves its number of subepochs for the next epoch to approach the
network-wide target (Eq. 6).
"""
from __future__ import annotations

import numpy as np
import torch

N_MAX = 1 << 10  # safety cap on subepochs (bounds record volume)


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
