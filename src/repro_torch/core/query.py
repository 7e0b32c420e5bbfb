"""Central querying (paper §4.3): composite sketches from subepoch
records, and the fleet routes over window stacks (port of
``repro/core/query.py``).

The record plane (``query_epoch``, ``query_window``) is what the
controller runs on the records the switches export.  Per epoch:
  Step 1 — the caller retrieves the records of the fragments on the
  queried flow's path (all flows in one call share a path).
  Step 2 — every record is queried as a single-row sketch, its estimate is
  split over ``N_R = n_m / n`` *normalized* subepochs, the
  per-normalized-subepoch estimates are merged across fragments (min for
  CMS, median for CS/UnivMon), temporal blind spots are filled with the
  mean of the observed normalized subepochs, and the slot estimates are
  summed into the epoch estimate.
It is host numpy, vectorized over the queried keys, as in the reference.

``fleet_query_window`` is the numpy path for windows whose counters the
record plane has already copied to the host (as row groups);
``fleet_query_window_device`` runs the same §4.3 fragment merge where a
resident window lives.  Both are the fleet twins of
``query_window(merge="fragment")``: each on-path row's record is scaled
to the epoch (x n, §1), merged across rows (min for Count-Min, median for
Count Sketch / UnivMon levels), and summed over the window (O_Q =
Sum(O)).

The UnivMon G-sum and entropy (§6.2: ``um_gsum_combine``,
``um_gsum_window``, ``um_entropy_window``) combine per-level estimates
from either plane with the top-down Y-recursion.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..kernels.sketch_update import fleet as FK
from . import hashing as H
from .fragment import EpochRecords, level_seed_mix


def _raw_estimates(rec: EpochRecords, keys: np.ndarray,
                   level: Optional[int]):
    """One record-set as single-row sketches: its counters (the level's,
    for UnivMon), each key's column and its sign (1.0 for cms)."""
    col_seed, sign_seed, _ = rec.seeds()
    counters = rec.counters
    if rec.kind == "um":
        assert level is not None
        counters = counters[level]
        col_seed = level_seed_mix(col_seed, level)
        sign_seed = level_seed_mix(sign_seed, level)
    w = counters.shape[-1]
    col = H.hash_mod(keys, col_seed, w)
    signed = rec.kind in ("cs", "um")
    sgn = H.hash_sign(keys, sign_seed).astype(np.float64) if signed else 1.0
    return counters, col, sgn


def _fill_layer(layer: np.ndarray, raw: np.ndarray, sub: np.ndarray,
                n_r: int, sel: Optional[np.ndarray] = None) -> None:
    """Spread raw estimates over their N_R normalized-subepoch slots."""
    n_keys = layer.shape[0]
    o = raw / n_r
    rows = np.arange(n_keys)
    cols = sub.astype(np.int64)[:, None] * n_r + np.arange(n_r)[None, :]
    if sel is None:
        layer[rows[:, None], cols] = o[:, None]
    else:
        layer[rows[sel][:, None], cols[sel]] = o[sel][:, None]


def query_epoch(records: Sequence[EpochRecords], keys: np.ndarray,
                kind: str, single_hop: Optional[np.ndarray] = None,
                level: Optional[int] = None,
                merge: str = "subepoch") -> np.ndarray:
    """Epoch estimate for each key from the on-path fragments' records.

    merge="subepoch": the Fig. 9 / §4.3 Step-2 procedure — normalize all
    records into n_m subepoch slots, merge per slot (min/median), fill
    temporal blind spots with the mean of covered slots, sum.

    merge="fragment": each fragment's record is scaled proportionally
    (x n, §1) into an epoch-level estimate, then min/median is taken
    across fragments.
    """
    keys = np.asarray(keys, dtype=np.uint32)
    n_keys = len(keys)
    if n_keys == 0 or not records:
        return np.zeros(n_keys)
    if merge == "fragment":
        return _query_epoch_fragment_merge(records, keys, kind, single_hop,
                                           level)
    if merge != "subepoch":
        raise ValueError(f"unknown merge {merge!r}; expected 'subepoch' or "
                         "'fragment'")
    n_m = max(r.n for r in records)

    layers: List[np.ndarray] = []
    for rec in records:
        counters, col, sgn = _raw_estimates(rec, keys, level)
        _, _, sub_seed = rec.seeds()
        sub = H.hash_pow2(keys, sub_seed, rec.n)
        n_r = n_m // rec.n
        raw = counters[sub, col].astype(np.float64) * sgn
        layer = np.full((n_keys, n_m), np.nan)
        _fill_layer(layer, raw, sub, n_r)
        layers.append(layer)
        # §4.4 mitigation: single-hop flows carry a second subepoch record.
        if rec.mitigation and rec.n >= 2 and single_hop is not None \
                and single_hop.any():
            sub2 = (sub + rec.n // 2) & (rec.n - 1)
            raw2 = counters[sub2, col].astype(np.float64) * sgn
            layer2 = np.full((n_keys, n_m), np.nan)
            _fill_layer(layer2, raw2, sub2, n_r, sel=single_hop)
            layers.append(layer2)

    est = np.stack(layers)  # (n_layers, n_keys, n_m)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        if kind == "cms":
            merged = np.nanmin(est, axis=0)
        else:
            merged = np.nanmedian(est, axis=0)
        # Temporal blind spots: extrapolate from the mean of observed slots.
        fill = np.nanmean(merged, axis=1, keepdims=True)
    fill = np.where(np.isnan(fill), 0.0, fill)
    merged = np.where(np.isnan(merged), fill, merged)
    return merged.sum(axis=1)


def _query_epoch_fragment_merge(records, keys, kind, single_hop, level):
    ests = np.empty((len(records), len(keys)))
    for i, rec in enumerate(records):
        counters, col, sgn = _raw_estimates(rec, keys, level)
        _, _, sub_seed = rec.seeds()
        sub = H.hash_pow2(keys, sub_seed, rec.n)
        raw = counters[sub, col].astype(np.float64) * sgn
        if rec.mitigation and rec.n >= 2 and single_hop is not None \
                and single_hop.any():
            sub2 = (sub + rec.n // 2) & (rec.n - 1)
            raw2 = counters[sub2, col].astype(np.float64) * sgn
            raw = np.where(single_hop, (raw + raw2) / 2.0, raw)
        ests[i] = raw * rec.n  # proportional scaling to the epoch (§1)
    if kind == "cms":
        return ests.min(axis=0)
    return np.median(ests, axis=0)


def path_groups(paths: Sequence[Sequence[int]]) -> Dict[Tuple[int, ...],
                                                          np.ndarray]:
    """The indices of ``paths`` grouped by path, in the order of each
    path's first appearance: the groups ``query_flows`` and
    ``query_entropy`` query, in the order they meet them."""
    with obs.span("query.path_groups"):
        groups: Dict[Tuple[int, ...], List[int]] = {}
        for i, p in enumerate(paths):
            groups.setdefault(tuple(p), []).append(i)
        return {p: np.asarray(i) for p, i in groups.items()}


def window_observability(records_by_epoch: Sequence[Sequence],
                         ) -> Tuple[int, float]:
    """``(observable_epochs, scale)`` of a record-plane query window: how
    many epochs contribute at least one record, and the §4.3 blind-epoch
    extrapolation factor E / E_observable (``inf`` when every epoch is
    blind)."""
    n = len(records_by_epoch)
    obs = sum(1 for records in records_by_epoch if records)
    return obs, (n / obs if obs else float("inf"))


def query_window(records_by_epoch: Sequence[Sequence[EpochRecords]],
                 keys: np.ndarray, kind: str,
                 single_hop: Optional[np.ndarray] = None,
                 level: Optional[int] = None,
                 merge: str = "subepoch",
                 chunk: int = 16384) -> np.ndarray:
    """Sum of per-epoch estimates over a query window (O_Q = Sum(O)),
    ``chunk`` keys at a time."""
    keys = np.asarray(keys, dtype=np.uint32)
    out = np.zeros(len(keys))
    for start in range(0, len(keys), chunk):
        sl = slice(start, start + chunk)
        sh = single_hop[sl] if single_hop is not None else None
        for records in records_by_epoch:
            if records:
                out[sl] += query_epoch(records, keys[sl], kind,
                                       single_hop=sh, level=level,
                                       merge=merge)
    return out


def fleet_query_epoch(stacked, col_seeds: np.ndarray,
                      sign_seeds: np.ndarray, sub_seeds: np.ndarray,
                      ns: np.ndarray, widths: np.ndarray,
                      keys: np.ndarray, kind: str,
                      frag_sel: Optional[np.ndarray] = None,
                      mit: Optional[np.ndarray] = None,
                      single_hop: bool = False) -> np.ndarray:
    """Batched epoch point query over one epoch's host counters, in
    float64.  ``stacked`` is a dense ``(n_rows, n_sub_max, width_max)``
    array, or the epoch's row groups: ``(rows, (R_g, n_g, w_g) array)``
    pairs that cover the rows.  The per-row arrays (seeds, ``ns``,
    ``widths``, ``mit``) are indexed by row.  ``frag_sel`` keeps the
    on-path rows (§4.3 Step 1); ``single_hop`` averages the §4.4
    second-subepoch record on rows flagged in ``mit``."""
    keys = np.asarray(keys, dtype=np.uint32)
    groups = ([(np.arange(stacked.shape[0]), stacked)]
              if isinstance(stacked, np.ndarray) else list(stacked))
    n_rows = sum(len(rows) for rows, _ in groups)
    sel = np.ones(n_rows, bool)
    if frag_sel is not None:
        sel = np.asarray(frag_sel, bool)
        if not sel.any():
            raise ValueError(
                "fleet_query_epoch: frag_sel selects no rows — an "
                "all-masked merge has no survivor")
    if len(keys) == 0 or n_rows == 0:
        return np.zeros(len(keys))
    ns, widths = np.asarray(ns, np.int64), np.asarray(widths, np.int64)
    col_seeds, sign_seeds, sub_seeds = (
        np.asarray(col_seeds), np.asarray(sign_seeds), np.asarray(sub_seeds))
    k2 = keys[None, :]                                # (1, K)
    raws = []
    for rows, counters in groups:
        keep = np.flatnonzero(sel[np.asarray(rows)])  # positions in the group
        if not len(keep):
            continue
        r = np.asarray(rows)[keep]
        ns_r = ns[r][:, None]                         # (F, 1)
        col = H.hash_mod(k2, col_seeds[r][:, None], widths[r][:, None])
        sub = H.hash_pow2(k2, sub_seeds[r][:, None], ns_r)
        pos = keep[:, None]
        raw = counters[pos, sub, col].astype(np.float64)
        if single_hop and mit is not None and np.asarray(mit)[r].any():
            sub2 = (sub + ns_r // 2) & (ns_r - 1)
            raw2 = counters[pos, sub2, col].astype(np.float64)
            use = np.asarray(mit, bool)[r][:, None] & (ns_r >= 2)
            raw = np.where(use, 0.5 * (raw + raw2), raw)
        if kind in ("cs", "um"):
            raw = raw * H.hash_sign(k2, sign_seeds[r][:, None]
                                    ).astype(np.float64)
        raws.append(raw * ns_r.astype(np.float64))
    raw = np.concatenate(raws)
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
    """Window point query over host fleet counters: the sum of per-epoch
    ``fleet_query_epoch`` calls, each over that epoch's dense stack or row
    groups, reading its seeds (and, with ``widths=None``, its hash moduli)
    from that epoch's table."""
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
                              single_hop: bool = False,
                              key_group: Optional[np.ndarray] = None,
                              ) -> np.ndarray:
    """Device twin of ``fleet_query_window`` on a resident window stack —
    see ``repro_torch.kernels.sketch_query.fleet_window_query_device``."""
    from ..kernels.sketch_query import fleet_window_query_device

    return fleet_window_query_device(stack, params_by_epoch, keys, kind,
                                     frag_sel=frag_sel,
                                     single_hop=single_hop,
                                     key_group=key_group)


def um_fleet_query_window_device(stack, params_by_epoch, keys: np.ndarray,
                                 n_levels: int,
                                 frag_sel: Optional[np.ndarray] = None,
                                 ) -> np.ndarray:
    """All ``n_levels`` UnivMon window estimates in one device call — thin
    re-export of ``repro_torch.kernels.sketch_query.um_window_query_device``
    (the §6.2 per-level inputs; see ``FleetEpochRunner
    .um_level_window_query`` for the routed entry point).  A row-sharded
    window is passed as its row groups, each on its shard's device, in
    place of the reference's ``mesh=``."""
    from ..kernels.sketch_query import um_window_query_device

    return um_window_query_device(stack, params_by_epoch, keys, n_levels,
                                  frag_sel=frag_sel)


# ---------------------------------------------------------------------------
# UnivMon network-wide G-sum / entropy over composite sketches (§6.2)
# ---------------------------------------------------------------------------


def um_gsum_combine(ests: np.ndarray, lvl: np.ndarray, g,
                    k_heavy: int = 1024) -> float:
    """The UnivMon top-down Y-recursion over precomputed per-level window
    estimates (``ests``: (n_levels, K); ``lvl``: (K,) level membership), in
    float64 on the host.  ``kernels.sketch_query.um_gsum_device`` is its
    device twin."""
    n_levels = ests.shape[0]
    y = 0.0
    for l in range(n_levels - 1, -1, -1):
        sel = lvl >= l
        if not sel.any():
            y = 2.0 * y
            continue
        est = np.maximum(ests[l, sel], 1.0)
        order = np.argsort(-est)[:k_heavy]
        hh_est = est[order]
        in_next = (lvl[sel][order] >= (l + 1)).astype(np.float64)
        if l == n_levels - 1:
            y = float(np.sum(g(hh_est)))
        else:
            y = 2.0 * y + float(np.sum((1.0 - 2.0 * in_next) * g(hh_est)))
    return y


def um_gsum_window(records_by_epoch_per_path, keys_per_path, g,
                   n_levels: int, level_seed: int,
                   k_heavy: int = 1024, merge: str = "subepoch") -> float:
    """Recursive UnivMon estimator over disaggregated composite sketches:
    per-level window frequencies of every path group's candidate keys from
    its records (``query_window`` at each level, ``merge`` the §4.3
    subepoch merge or the fragment merge), then ``um_gsum_combine``."""
    all_lvl, est_per_level = [], []
    for keys, recs_by_epoch in zip(keys_per_path, records_by_epoch_per_path):
        keys = np.asarray(keys, dtype=np.uint32)
        if len(keys) == 0:
            continue
        lvl = H.level_of(keys, level_seed, n_levels)
        ests = np.zeros((n_levels, len(keys)))
        for l in range(n_levels):
            m = lvl >= l
            if not m.any():
                continue
            ests[l, m] = query_window(recs_by_epoch, keys[m], "um", level=l,
                                      merge=merge)
        all_lvl.append(lvl)
        est_per_level.append(ests)
    if not all_lvl:
        return 0.0
    return um_gsum_combine(np.concatenate(est_per_level, axis=1),
                           np.concatenate(all_lvl), g, k_heavy=k_heavy)


def um_entropy_window(records_by_epoch_per_path, keys_per_path,
                      n_levels: int, level_seed: int, total: float,
                      k_heavy: int = 1024,
                      merge: str = "subepoch") -> float:
    """Empirical entropy in bits over the query window:
    ``log2(total) - G / total`` with ``G`` the G-sum of ``x log2 x``."""
    s = um_gsum_window(records_by_epoch_per_path, keys_per_path,
                       lambda x: x * np.log2(np.maximum(x, 1.0)),
                       n_levels, level_seed, k_heavy=k_heavy, merge=merge)
    if total <= 0:
        return 0.0
    return float(np.log2(total) - s / total)
