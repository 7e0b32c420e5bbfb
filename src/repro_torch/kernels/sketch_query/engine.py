"""Device-resident batched query plane (paper §4.3): gather + merge over a
window's stacked counters (port of ``repro/kernels/sketch_query/engine.py``).

One pass, in PyTorch ops:

  1. recompute every row's column/sign/subepoch hashes for the key batch
     (``core.hashing``'s int64 torch twins of the uint32 arithmetic);
  2. gather each (epoch, row)'s raw estimate
     ``stack[e, r, sub(e,r,k), col(e,r,k)]`` for all keys at once, for
     the rows some epoch selects, from the row group that holds the row
     (a window buffer keeps one ``(E, R_g, n_g, w_g)`` tensor per
     subepoch count, not one stack padded to the fleet-wide ceiling), on
     the group's own device;
  3. copy each group's ``(E, R_g, K)`` slice to the merge device in row
     order (``_all_gather_rows``, the reference's tiled ``all_gather``
     over the ``switch`` mesh axis; a no-op off a mesh), then merge
     across rows per epoch — min for Count-Min, a +inf-masked median
     for Count Sketch (``frag_sel`` keeps the on-path rows, §4.3 Step 1);
  4. sum over the window's epochs (O_Q = Sum(O)).

Under a device mesh (``launch.mesh``) each shard's groups stay on its
device: only the gathered estimate slices cross to the merge device, and
the merge sees them in single-device row order, so the estimates are
bit-identical to the unsharded fleet's.  The port's windows are row
groups over the unpadded row space, so it needs no pad rows.

UnivMon (§6.2): ``um_window_query_device`` runs the same gather over
every (epoch, fragment, level) row and the median over the fragments of
each level, returning ``(n_levels, K)`` estimates; ``um_gsum_device`` runs
the top-down G-sum over them on the device.

The reference's version is XLA, not Pallas, so it needs no hand-written
kernel.  Only the ``(K,)`` estimates cross back to the host.  Keys are not
padded to power-of-two buckets: eager PyTorch compiles nothing per shape.

Each entry point runs in three stages: every host input (keys, seeds,
``n``/width tables, row positions, masks) is uploaded first, in one pass
over the row groups; the device compute then runs under
``sanitize.transfer_guard()`` (armed by ``REPRO_SANITIZE=1``: any op in it
that makes the host wait for the card raises); the estimates are copied
out after the guard.  The host boundary of this module is exactly its
entry points and ``_prep_window_params`` (host tables only).

Exactness: counters are exact integers in f32 and the x``n`` scaling is a
power of two, so every per-row estimate is exact and the min/median
*selection* equals the float64 host oracle's; only the CS median midpoint
rounds in f32.  The window sum runs in float64.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ... import obs, sanitize
from ...core.hashing import hash_mod_torch, hash_pow2_torch, hash_sign_torch
from ...device import resolve_device
from ..sketch_update.fleet import (PARAM_COL_SEED, PARAM_MIT, PARAM_N_SUB,
                                   PARAM_SIGN_SEED, PARAM_SUB_SEED,
                                   PARAM_WIDTH)


def _gather_raw(stack: torch.Tensor, pos, col_seeds, sign_seeds, sub_seeds,
                ns, widths, mit_rows, keys, *, signed: bool,
                mitigate: bool) -> torch.Tensor:
    """(E, R_g, S, W) stack + (R,) row positions ``pos`` in it + (K,) keys
    -> (E, R, K) raw estimates of those rows (signed, §4.4-averaged, x n
    scaled).  Seeds are (E, R), ``ns``/``widths``/``mit_rows`` (R,), all
    int64/bool tensors on the stack's device."""
    e_count = stack.shape[0]
    k = keys[None, None, :]
    col = hash_mod_torch(k, col_seeds[:, :, None], widths[None, :, None])
    sub = hash_pow2_torch(k, sub_seeds[:, :, None], ns[None, :, None])
    e_idx = torch.arange(e_count, device=stack.device)[:, None, None]
    r_idx = pos[None, :, None]
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
    otherwise.  ``frag_sel`` is (R,), (E, R) or, per key, (E, R, K) bool.
    An (epoch, key) that selects no row merges to 0."""
    sel = frag_sel if frag_sel.ndim > 1 else frag_sel[None, :]
    sel = sel if sel.ndim == 3 else sel[:, :, None]
    masked = torch.where(sel, raw, raw.new_full((), float("inf")))
    if kind == "cms":
        merged = masked.min(dim=1).values                 # (E, K)
    else:
        # +inf-masked rows sort to the top, so ranks (m-1)//2 and m//2 of
        # the ascending sort are the two middle *selected* values.
        srt = masked.sort(dim=1).values
        m = sel.sum(dim=1, keepdim=True)                  # (E, 1, 1|K)
        shape = (srt.shape[0], 1, srt.shape[2])
        lo = torch.take_along_dim(
            srt, ((m - 1).clamp(min=0) // 2).expand(shape), dim=1)
        hi = torch.take_along_dim(srt, (m // 2).expand(shape), dim=1)
        merged = (0.5 * (lo + hi))[:, 0, :]
    return torch.where(sel.any(dim=1), merged, torch.zeros_like(merged))


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
                              single_hop: bool = False,
                              key_group: Optional[np.ndarray] = None,
                              ) -> np.ndarray:
    """Batched window point query on a resident window.

    Args:
      stack: the window's counters — a dense ``(E, R, n_sub_max,
        width_max)`` f32 tensor, or the row groups a window buffer holds:
        ``(rows, counters)`` pairs with ``counters`` ``(E, R_g, n_g,
        w_g)`` for the rows ``rows`` of every epoch, each group on its
        own device (a mesh shard's).
      params_by_epoch: E host ``(R, N_PARAMS)`` int32 tables (per-epoch
        seeds; ``n_sub``/``width`` frozen across the window).
      keys: (K,) uint32 key batch.
      kind: "cs" | "cms" | "um" (um rows are signed CS levels; pass the
        queried level's rows via ``frag_sel``).
      frag_sel: optional (R,) or (E, R) bool on-path row mask; every
        epoch must select at least one row.  With ``key_group``, a
        ``(G, E, R)`` mask, one per key group (e.g. per path).
      single_hop: apply the §4.4 second-subepoch average on PARAM_MIT rows.
      key_group: optional (K,) indices into ``frag_sel``'s first axis: key
        ``k`` merges the rows ``frag_sel[key_group[k]]`` selects, and an
        epoch that selects none of them adds nothing to its sum.

    Returns the (K,) float64 window estimates.
    """
    with obs.span("query.stage"):
        keys = np.asarray(keys, dtype=np.uint32)
        groups = ([(np.arange(stack.shape[1]), stack)]
                  if isinstance(stack, torch.Tensor) else list(stack))
        params, ns, widths = _prep_window_params(groups, params_by_epoch)
        e_count, n_rows = params.shape[:2]
        if key_group is not None:
            key_group = np.asarray(key_group, np.int64)
            frag_sel = np.asarray(frag_sel, bool)
            if frag_sel.shape[1:] != (e_count, n_rows) \
                    or len(key_group) != len(keys):
                raise ValueError(f"frag_sel {frag_sel.shape} and key_group "
                                 f"{key_group.shape} do not fit {e_count} "
                                 f"epochs of {n_rows} rows and {len(keys)} "
                                 "keys")
            need = frag_sel[np.unique(key_group)].any(axis=(0, 1))
        else:
            frag_sel = (np.ones(n_rows, bool) if frag_sel is None
                        else np.asarray(frag_sel, bool))
            sel2 = np.atleast_2d(frag_sel)
            if not sel2.any(axis=1).all():
                bad = np.flatnonzero(~sel2.any(axis=1))
                raise ValueError(
                    "fleet_window_query_device: no on-path fragment selected "
                    f"(epoch offsets {bad.tolist()} of "
                    f"{len(params_by_epoch)}) — an all-masked merge has no "
                    "survivor")
            need = sel2.any(axis=0)
        if len(keys) == 0:
            return np.zeros(0)
        # the merge runs on the first group's device: under a mesh, shard 0's
        # groups come first, on the mesh's first device
        dev = groups[0][1].device
        staged = _stage_groups(groups, params, ns, widths, keys, need, dev,
                               mitigate=bool(single_hop))
        sel = _put(frag_sel, dev, torch.bool)
        kg = None if key_group is None else _put(key_group, dev)
    with obs.span("query.gather"), sanitize.transfer_guard():
        raw = _gather_groups(staged, e_count, n_rows, len(keys), dev,
                             signed=kind in ("cs", "um"))
        if kg is not None:
            sel = sel[kg].permute(1, 2, 0)                   # (E, R, K)
        est = _masked_merge(raw, sel, kind=kind).to(torch.float64).sum(
            dim=0)
    # (K,) estimates: the only counter-derived bytes that leave the device
    with obs.span("query.estimates.wait"):
        return est.cpu().numpy()


def _put(a, dev, dtype=torch.int64) -> torch.Tensor:
    """A host array on ``dev`` as ``dtype`` (an upload: before the guard),
    its bytes counted on the open span."""
    t = torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)
    obs.add("bytes", t.nbytes)
    return t


def _all_gather_rows(part: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """One row group's ``(E, R_g, K)`` f32 estimate slice on the merge
    device: the only counter-derived tensor that crosses devices under a
    mesh (peer to peer between cards), the reference's
    ``all_gather(..., tiled=True)``.  A no-op on the merge device."""
    return part.to(dev)


def _stage_groups(groups, params: np.ndarray, ns: np.ndarray,
                  widths: np.ndarray, keys: np.ndarray, need: np.ndarray,
                  dev: torch.device, *, mitigate: bool):
    """Upload what ``_gather_groups`` reads, in one pass over a window's
    row groups and before any compute: for each group with a row that
    ``need`` (R,) selects, ``(counters, inputs, rows on dev)``, where
    ``inputs`` are ``_gather_raw``'s positional arguments after the stack
    on the group's own device (the keys once per device).  ``mitigate``
    asks for the §4.4 average on the rows that mitigate; it is dropped
    when no row does.  Returns ``(staged, mitigate)``."""
    mit_rows = params[0, :, PARAM_MIT] != 0
    mitigate = mitigate and bool(mit_rows.any())
    keys64 = keys.astype(np.int64)
    k_on = {}
    staged = []
    for rows, counters in groups:
        pos = np.flatnonzero(need[np.asarray(rows)])
        if not len(pos):
            continue
        r = np.asarray(rows)[pos]
        gdev = counters.device
        if gdev not in k_on:
            k_on[gdev] = _put(keys64, gdev)
        inputs = (_put(pos, gdev), _put(params[:, r, PARAM_COL_SEED], gdev),
                  _put(params[:, r, PARAM_SIGN_SEED], gdev),
                  _put(params[:, r, PARAM_SUB_SEED], gdev), _put(ns[r], gdev),
                  _put(widths[r], gdev), _put(mit_rows[r], gdev, torch.bool),
                  k_on[gdev])
        staged.append((counters, inputs, _put(r, dev)))
    return staged, mitigate


def _gather_groups(staged, e_count: int, n_rows: int, n_keys: int,
                   dev: torch.device, *, signed: bool) -> torch.Tensor:
    """``_gather_raw`` over a window's staged row groups
    (``_stage_groups``), each on its own device: the ``(E, R, K)`` f32 raw
    estimates of the staged rows, gathered into one tensor on ``dev`` in
    row order.  The other rows are left unwritten; the merge masks them.
    Device compute only: it uploads nothing and reads nothing back."""
    groups, mitigate = staged
    raw = torch.empty((e_count, n_rows, n_keys), dtype=torch.float32,
                      device=dev)
    for counters, inputs, rows in groups:
        part = _gather_raw(counters, *inputs, signed=signed,
                           mitigate=mitigate)
        raw[:, rows] = _all_gather_rows(part, dev)
    return raw


def um_window_query_device(stack, params_by_epoch: Sequence[np.ndarray],
                           keys: np.ndarray, n_levels: int,
                           frag_sel: Optional[np.ndarray] = None,
                           ) -> np.ndarray:
    """All ``n_levels`` UnivMon Count-Sketch window estimates for a key
    batch in one batched pass (the §6.2 G-sum inputs).

    Args:
      stack: a resident window with ``n_levels`` virtual rows per
        fragment, fragment-major — a dense ``(E, F * n_levels, S, W)``
        tensor or its row groups, as for ``fleet_window_query_device``.
      params_by_epoch: E host ``(F * n_levels, N_PARAMS)`` tables with the
        per-level mixed seeds (``core.fleet.build_params``).
      keys: (K,) uint32 key batch.
      frag_sel: optional (F,) or (E, F) bool on-path *fragment* mask
        (the level axis is structural, not a mask); every epoch must keep
        a fragment.

    One gather covers every (epoch, fragment, level) row; the rows are
    reshaped to ``(E * L, F, K)``, epoch-major with the level inside, so
    ``_masked_merge``'s median runs over the fragments of each (epoch,
    level), and the epochs are summed.  Returns ``(n_levels, K)`` float64
    ``merge="fragment"`` window estimates; level ``l``'s row means
    something for keys with ``level_of >= l``.  No §4.4 average: the G-sum
    queries without single-hop records, as the host ``um_gsum_window``.
    """
    with obs.span("query.stage"):
        keys = np.asarray(keys, dtype=np.uint32)
        groups = ([(np.arange(stack.shape[1]), stack)]
                  if isinstance(stack, torch.Tensor) else list(stack))
        params, ns, widths = _prep_window_params(groups, params_by_epoch)
        e_count, n_rows = params.shape[:2]
        if n_levels < 1 or n_rows % n_levels:
            raise ValueError(f"{n_rows} rows are not whole fragments of "
                             f"{n_levels} levels")
        n_frags = n_rows // n_levels
        frag_sel = (np.ones(n_frags, bool) if frag_sel is None
                    else np.asarray(frag_sel, bool))
        sel2 = np.atleast_2d(frag_sel)
        if sel2.shape[-1] != n_frags or sel2.shape[0] not in (1, e_count):
            raise ValueError(f"frag_sel {frag_sel.shape} is not ({n_frags},) "
                             f"or ({e_count}, {n_frags})")
        if not sel2.any(axis=1).all():
            bad = np.flatnonzero(~sel2.any(axis=1))
            raise ValueError(
                "um_window_query_device: no on-path fragment selected "
                f"(epoch offsets {bad.tolist()} of {e_count}) — an "
                "all-masked merge has no survivor")
        if len(keys) == 0:
            return np.zeros((n_levels, 0))
        dev = groups[0][1].device   # shard 0's, as above
        staged = _stage_groups(groups, params, ns, widths, keys,
                               np.repeat(sel2.any(axis=0), n_levels), dev,
                               mitigate=False)
        if frag_sel.ndim == 2:   # (E, F) -> the (E * L, F) row layout below
            frag_sel = np.repeat(frag_sel, n_levels, axis=0)
        sel = _put(frag_sel, dev, torch.bool)
    with obs.span("query.gather"), sanitize.transfer_guard():
        raw = _gather_groups(staged, e_count, n_rows, len(keys), dev,
                             signed=True)
        raw = (raw.reshape(e_count, n_frags, n_levels, -1).transpose(1, 2)
               .reshape(e_count * n_levels, n_frags, -1))
        merged = _masked_merge(raw, sel, kind="um")        # (E * L, K)
        est = merged.reshape(e_count, n_levels, -1).to(torch.float64).sum(
            dim=0)
    # (L, K) estimates: the only counter-derived bytes that leave the device
    with obs.span("query.estimates.wait"):
        return est.cpu().numpy()


def um_gsum_device(ests, lvl: np.ndarray, g, k_heavy: int = 1024,
                   device=None) -> float:
    """Device twin of ``core.query.um_gsum_combine``: the top-down UnivMon
    Y-recursion over ``(n_levels, K)`` per-level estimates, in f32 torch
    ops on ``device`` (default ``cuda``; a tensor's own device).

    At each level the unselected keys (``lvl < l``) become ``-inf`` and
    the ``k_heavy`` largest estimates are taken.  ``lax.top_k`` in the
    reference breaks ties by the lower index; ``torch.topk`` promises no
    order, so the selection is a stable sort of ``-est``.  ``g`` is a
    torch callable (``core.disketch._g_entropy``).  Accumulates in f32 as
    the reference's device G-sum does: expect ~1e-5 relative agreement
    with the float64 host combine, and the same keys selected."""
    with obs.span("query.gsum"):
        if isinstance(ests, torch.Tensor):
            est_all, dev = ests.to(torch.float32), ests.device
        else:
            dev = resolve_device(device)
            est_all = torch.as_tensor(np.asarray(ests, np.float32), device=dev)
        lv = torch.as_tensor(np.asarray(lvl, np.int64), device=dev)
        n_levels, n_keys = est_all.shape
        k = min(int(k_heavy), n_keys)
        neg_inf = float("-inf")
        with sanitize.transfer_guard():
            y = torch.zeros((), dtype=torch.float32, device=dev)
            for l in range(n_levels - 1, -1, -1):
                est = torch.where(lv >= l, torch.clamp_min(est_all[l], 1.0),
                                  neg_inf)
                idx = torch.sort(-est, stable=True).indices[:k]
                vals = est[idx]
                valid = vals > neg_inf
                gv = torch.where(valid, g(torch.where(valid, vals, 1.0)), 0.0)
                if l == n_levels - 1:
                    y = gv.sum()
                else:
                    in_next = ((lv[idx] >= l + 1) & valid).to(torch.float32)
                    y = 2.0 * y + ((1.0 - 2.0 * in_next) * gv).sum()
        # one scalar: the only counter-derived value that leaves the device
        with obs.span("query.gsum.wait"):
            return float(y)
