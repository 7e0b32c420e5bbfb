"""Device-resident batched query plane (paper §4.3): gather + merge over a
window's stacked counters (port of ``repro/kernels/sketch_query/engine.py``
without the device mesh).

One pass, in PyTorch ops on the device that holds the stack:

  1. recompute every row's column/sign/subepoch hashes for the key batch
     (``core.hashing``'s int64 torch twins of the uint32 arithmetic);
  2. gather each (epoch, row)'s raw estimate
     ``stack[e, r, sub(e,r,k), col(e,r,k)]`` for all keys at once, from
     the row group that holds the row (a window buffer keeps one
     ``(E, R_g, n_g, w_g)`` tensor per subepoch count, not one stack
     padded to the fleet-wide ceiling);
  3. merge across rows per epoch — min for Count-Min, a +inf-masked median
     for Count Sketch (``frag_sel`` keeps the on-path rows, §4.3 Step 1);
  4. sum over the window's epochs (O_Q = Sum(O)).

The reference's version is XLA, not Pallas, so it needs no hand-written
kernel.  Only the ``(K,)`` estimates cross back to the host.  Keys are not
padded to power-of-two buckets: eager PyTorch compiles nothing per shape.

Exactness: counters are exact integers in f32 and the x``n`` scaling is a
power of two, so every per-row estimate is exact and the min/median
*selection* equals the float64 host oracle's; only the CS median midpoint
rounds in f32.  The window sum runs in float64.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ...core.hashing import hash_mod_torch, hash_pow2_torch, hash_sign_torch
from ..sketch_update.fleet import (PARAM_COL_SEED, PARAM_MIT, PARAM_N_SUB,
                                   PARAM_SIGN_SEED, PARAM_SUB_SEED,
                                   PARAM_WIDTH)


def _gather_raw(stack: torch.Tensor, col_seeds, sign_seeds, sub_seeds, ns,
                widths, mit_rows, keys, *, signed: bool,
                mitigate: bool) -> torch.Tensor:
    """(E, R, S, W) stack + (K,) keys -> (E, R, K) raw per-row estimates
    (signed, §4.4-averaged, x n scaled).  Seeds are (E, R), ``ns``/
    ``widths``/``mit_rows`` (R,), all int64/bool tensors on the stack's
    device."""
    e_count, n_rows = stack.shape[:2]
    k = keys[None, None, :]
    col = hash_mod_torch(k, col_seeds[:, :, None], widths[None, :, None])
    sub = hash_pow2_torch(k, sub_seeds[:, :, None], ns[None, :, None])
    e_idx = torch.arange(e_count, device=stack.device)[:, None, None]
    r_idx = torch.arange(n_rows, device=stack.device)[None, :, None]
    raw = stack[e_idx, r_idx, sub, col]
    if mitigate:
        # §4.4: single-hop flows carry a second subepoch record at
        # sub + n/2 on mitigation rows; average the two.
        n = ns[None, :, None]
        raw2 = stack[e_idx, r_idx, (sub + (n >> 1)) & (n - 1), col]
        use = (mit_rows & (ns >= 2))[None, :, None]
        raw = torch.where(use, 0.5 * (raw + raw2), raw)
    if signed:
        raw = raw * hash_sign_torch(k, sign_seeds[:, :, None]).to(
            torch.float32)
    # Proportional scaling to the epoch (x n, §1): exact in f32.
    return raw * ns[None, :, None].to(torch.float32)


def _masked_merge(raw: torch.Tensor, frag_sel: torch.Tensor, *,
                  kind: str) -> torch.Tensor:
    """§4.3 merge across the row axis (axis 1): min for CMS, masked median
    otherwise.  ``frag_sel`` is (R,) or (E, R) bool; every epoch keeps at
    least one selected row (the entry point checks)."""
    sel = frag_sel if frag_sel.ndim == 2 else frag_sel[None, :]
    masked = torch.where(sel[:, :, None], raw,
                         torch.tensor(float("inf"), device=raw.device))
    if kind == "cms":
        return masked.min(dim=1).values                   # (E, K)
    # +inf-masked rows sort to the top, so ranks (m-1)//2 and m//2 of the
    # ascending sort are the two middle *selected* values.
    srt = masked.sort(dim=1).values
    m = sel.sum(dim=1)[:, None, None]                     # (E', 1, 1)
    shape = (srt.shape[0], 1, srt.shape[2])
    lo = torch.take_along_dim(srt, ((m - 1) // 2).expand(shape), dim=1)
    hi = torch.take_along_dim(srt, (m // 2).expand(shape), dim=1)
    return (0.5 * (lo + hi))[:, 0, :]


def _prep_window_params(groups, params_by_epoch: Sequence[np.ndarray]):
    """Validate the row groups against the per-epoch tables: ns and widths
    frozen across the window, every row in exactly one group, and each
    group's counters covering its rows' ``(n_sub, width)``.  Returns
    (params (E, R, N_PARAMS), ns, widths) on the host."""
    params = np.stack([np.asarray(p, np.int32) for p in params_by_epoch])
    e_count, n_rows = params.shape[:2]
    ns = params[0, :, PARAM_N_SUB]
    widths = params[0, :, PARAM_WIDTH]
    if not ((params[:, :, PARAM_N_SUB] == ns).all()
            and (params[:, :, PARAM_WIDTH] == widths).all()):
        raise ValueError("device window query requires ns/widths frozen "
                         "across the window")
    all_rows = np.concatenate([np.asarray(r) for r, _ in groups]) \
        if groups else np.zeros(0, np.int64)
    if not np.array_equal(np.sort(all_rows), np.arange(n_rows)):
        raise ValueError(f"row groups do not cover the {n_rows} rows of the "
                         "parameter tables exactly once")
    for rows, counters in groups:
        e, r, n, w = counters.shape
        if (e, r) != (e_count, len(rows)) or ns[rows].max() > n \
                or widths[rows].max() > w:
            raise ValueError(f"counters {tuple(counters.shape)} do not hold "
                             f"{len(rows)} rows of {e_count} epochs")
    return params, ns, widths


def fleet_window_query_device(stack, params_by_epoch: Sequence[np.ndarray],
                              keys: np.ndarray, kind: str,
                              frag_sel: Optional[np.ndarray] = None,
                              single_hop: bool = False) -> np.ndarray:
    """Batched window point query on a resident window.

    Args:
      stack: the window's counters on one device — a dense
        ``(E, R, n_sub_max, width_max)`` f32 tensor, or the row groups a
        window buffer holds: ``(rows, counters)`` pairs with ``counters``
        ``(E, R_g, n_g, w_g)`` for the rows ``rows`` of every epoch.
      params_by_epoch: E host ``(R, N_PARAMS)`` int32 tables (per-epoch
        seeds; ``n_sub``/``width`` frozen across the window).
      keys: (K,) uint32 key batch.
      kind: "cs" | "cms" | "um" (um rows are signed CS levels; pass the
        queried level's rows via ``frag_sel``).
      frag_sel: optional (R,) or (E, R) bool on-path row mask; every
        epoch must select at least one row.
      single_hop: apply the §4.4 second-subepoch average on PARAM_MIT rows.

    Returns the (K,) float64 window estimates.
    """
    keys = np.asarray(keys, dtype=np.uint32)
    groups = ([(np.arange(stack.shape[1]), stack)]
              if isinstance(stack, torch.Tensor) else list(stack))
    params, ns, widths = _prep_window_params(groups, params_by_epoch)
    e_count, n_rows = params.shape[:2]
    frag_sel = (np.ones(n_rows, bool) if frag_sel is None
                else np.asarray(frag_sel, bool))
    sel2 = np.atleast_2d(frag_sel)
    if not sel2.any(axis=1).all():
        bad = np.flatnonzero(~sel2.any(axis=1))
        raise ValueError(
            "fleet_window_query_device: no on-path fragment selected "
            f"(epoch offsets {bad.tolist()} of {len(params_by_epoch)}) — "
            "an all-masked merge has no survivor")
    if len(keys) == 0:
        return np.zeros(0)
    mit_rows = params[0, :, PARAM_MIT] != 0
    dev = groups[0][1].device

    def put(a, dtype=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    k = put(keys.astype(np.int64))
    mitigate = bool(single_hop) and bool(mit_rows.any())
    raw = torch.empty((e_count, n_rows, len(keys)), dtype=torch.float32,
                      device=dev)
    for rows, counters in groups:
        raw[:, put(rows)] = _gather_raw(
            counters, put(params[:, rows, PARAM_COL_SEED]),
            put(params[:, rows, PARAM_SIGN_SEED]),
            put(params[:, rows, PARAM_SUB_SEED]), put(ns[rows]),
            put(widths[rows]), put(mit_rows[rows], torch.bool), k,
            signed=kind in ("cs", "um"), mitigate=mitigate)
    merged = _masked_merge(raw, put(frag_sel, torch.bool), kind=kind)
    # (K,) estimates: the only counter-derived bytes that leave the device
    return merged.to(torch.float64).sum(dim=0).cpu().numpy()
