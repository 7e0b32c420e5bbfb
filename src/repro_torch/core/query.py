"""Central querying (paper §4.3) over fleet window stacks (port of the
fleet routes of ``repro/core/query.py``).

``fleet_query_window`` is the numpy path for windows whose stack the
record plane has already copied to the host; ``fleet_query_window_device``
runs the same §4.3 fragment merge where a resident stack lives.  Both are
the fleet twins of ``query_window(merge="fragment")``: each on-path row's
record is scaled to the epoch (x n, §1), merged across rows (min for
Count-Min, median for Count Sketch / UnivMon levels), and summed over the
window (O_Q = Sum(O)).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..kernels.sketch_update import fleet as FK
from . import hashing as H


def fleet_query_epoch(stacked: np.ndarray, col_seeds: np.ndarray,
                      sign_seeds: np.ndarray, sub_seeds: np.ndarray,
                      ns: np.ndarray, widths: np.ndarray,
                      keys: np.ndarray, kind: str,
                      frag_sel: Optional[np.ndarray] = None,
                      mit: Optional[np.ndarray] = None,
                      single_hop: bool = False) -> np.ndarray:
    """Batched epoch point query over one epoch's host
    ``(n_rows, n_sub_max, width_max)`` counters, in float64.  ``frag_sel``
    keeps the on-path rows (§4.3 Step 1); ``single_hop`` averages the §4.4
    second-subepoch record on rows flagged in ``mit``."""
    keys = np.asarray(keys, dtype=np.uint32)
    if frag_sel is not None:
        frag_sel = np.asarray(frag_sel, bool)
        if not frag_sel.any():
            raise ValueError(
                "fleet_query_epoch: frag_sel selects no rows — an "
                "all-masked merge has no survivor")
        stacked = stacked[frag_sel]
        col_seeds = np.asarray(col_seeds)[frag_sel]
        sign_seeds = np.asarray(sign_seeds)[frag_sel]
        sub_seeds = np.asarray(sub_seeds)[frag_sel]
        ns = np.asarray(ns)[frag_sel]
        widths = np.asarray(widths)[frag_sel]
        if mit is not None:
            mit = np.asarray(mit, bool)[frag_sel]
    if len(keys) == 0 or stacked.shape[0] == 0:
        return np.zeros(len(keys))
    ns = np.asarray(ns, np.int64)[:, None]            # (F, 1)
    widths = np.asarray(widths, np.int64)[:, None]
    k2 = keys[None, :]                                # (1, K)
    col = H.hash_mod(k2, np.asarray(col_seeds)[:, None], widths)
    sub = H.hash_pow2(k2, np.asarray(sub_seeds)[:, None], ns)
    rows = np.arange(stacked.shape[0])[:, None]
    raw = stacked[rows, sub, col].astype(np.float64)
    if single_hop and mit is not None and mit.any():
        sub2 = (sub + ns // 2) & (ns - 1)
        raw2 = stacked[rows, sub2, col].astype(np.float64)
        use = np.asarray(mit, bool)[:, None] & (ns >= 2)
        raw = np.where(use, 0.5 * (raw + raw2), raw)
    if kind in ("cs", "um"):
        raw = raw * H.hash_sign(k2, np.asarray(sign_seeds)[:, None]
                                ).astype(np.float64)
    raw = raw * ns.astype(np.float64)
    if kind == "cms":
        return raw.min(axis=0)
    return np.median(raw, axis=0)


def _per_epoch_sels(frag_sel, n_epochs: int) -> List:
    """One mask per epoch from None, a single (n_rows,) mask, or an
    (E, n_rows) array / sequence of E masks."""
    if frag_sel is None:
        return [None] * n_epochs
    if isinstance(frag_sel, np.ndarray) and frag_sel.ndim == 1:
        return [frag_sel] * n_epochs
    sels = list(frag_sel)
    if len(sels) != n_epochs:
        raise ValueError(f"per-epoch frag_sel has {len(sels)} masks for "
                         f"{n_epochs} epochs")
    return sels


def fleet_query_window(stacked_by_epoch: Sequence[np.ndarray],
                       params_by_epoch: Sequence[np.ndarray],
                       widths: Optional[np.ndarray], keys: np.ndarray,
                       kind: str, frag_sel=None,
                       single_hop: bool = False) -> np.ndarray:
    """Window point query over host fleet stacks: the sum of per-epoch
    ``fleet_query_epoch`` calls, each reading its seeds (and, with
    ``widths=None``, its hash moduli) from that epoch's table."""
    keys = np.asarray(keys, dtype=np.uint32)
    out = np.zeros(len(keys))
    sels = _per_epoch_sels(frag_sel, len(params_by_epoch))
    for stacked, p, sel in zip(stacked_by_epoch, params_by_epoch, sels):
        out += fleet_query_epoch(
            stacked,
            col_seeds=p[:, FK.PARAM_COL_SEED].astype(np.int64),
            sign_seeds=p[:, FK.PARAM_SIGN_SEED].astype(np.int64),
            sub_seeds=p[:, FK.PARAM_SUB_SEED].astype(np.int64),
            ns=p[:, FK.PARAM_N_SUB].astype(np.int64),
            widths=p[:, FK.PARAM_WIDTH].astype(np.int64)
            if widths is None else widths,
            keys=keys, kind=kind, frag_sel=sel,
            mit=p[:, FK.PARAM_MIT] != 0, single_hop=single_hop)
    return out


def fleet_query_window_device(stack, params_by_epoch, keys: np.ndarray,
                              kind: str,
                              frag_sel: Optional[np.ndarray] = None,
                              single_hop: bool = False) -> np.ndarray:
    """Device twin of ``fleet_query_window`` on a resident window stack —
    see ``repro_torch.kernels.sketch_query.fleet_window_query_device``."""
    from ..kernels.sketch_query import fleet_window_query_device

    return fleet_window_query_device(stack, params_by_epoch, keys, kind,
                                     frag_sel=frag_sel,
                                     single_hop=single_hop)
