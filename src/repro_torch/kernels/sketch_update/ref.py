"""Plain PyTorch versions of the sketch update (scatter-add semantics; port
of ``repro/kernels/sketch_update/ref.py``).

``row_contrib`` is the per-packet arithmetic of every update kernel —
hashed column, Count-Sketch sign, §4.1 monitored mask with the UnivMon
level and §4.4 terms — under one parameter row, given as scalars (one
fragment) or as per-packet tensors (a fleet's table gathered by row).
``sketch_update_ref`` is the single-fragment kernel's plain version; the
fleet kernels' plain versions (``fleet.py``) build on the same function.
uint32 words travel as int32 bit patterns and are hashed in int64 masked
to 32 bits (``core.hashing``).  Every result is exact: counters are
integer sums below 2^24.
"""
from __future__ import annotations

import torch

from ...core.hashing import hash_mod_torch, hash_u32_torch
from .kernel import LVL_FIELD_MASK, LVL_SHIFT, SH_SHIFT

_MASK32 = 0xFFFFFFFF


def row_contrib(keys: torch.Tensor, vals: torch.Tensor, ts: torch.Tensor, *,
                col_seed, sign_seed, sub_seed, width, n_sub, log2_n_sub,
                log2_te: int, signed: bool, level=None, mit=None):
    """Which packets a row monitors and where they land.

    ``keys``/``ts`` hold uint32 words (any integer dtype); the row's
    parameters are scalars or tensors broadcast against the packets.
    ``level`` (None: no level term) keeps packets whose folded level id
    is ``>= level``; ``mit`` (None: no §4.4 term) adds flagged single-hop
    packets in the flow's second subepoch where it is non-zero.

    Returns ``(sel, sub, col, val)``: the indices of the monitored
    packets, and every packet's subepoch, column and signed value.
    """
    k = keys.to(torch.int64) & _MASK32
    t = ts.to(torch.int64) & _MASK32
    n_mask = n_sub - 1
    sub_pkt = (t >> (log2_te - log2_n_sub)) & n_mask
    sub_flow = hash_u32_torch(k, sub_seed) & n_mask
    monitored = sub_pkt == sub_flow
    if mit is not None:
        sub2 = (sub_flow + ((n_mask + 1) >> 1)) & n_mask
        single_hop = (t >> SH_SHIFT) != 0
        monitored |= (mit != 0) & single_hop & (sub_pkt == sub2)
    if level is not None:
        monitored &= ((t >> LVL_SHIFT) & LVL_FIELD_MASK) >= level
    col = hash_mod_torch(k, col_seed, width)
    v = vals.to(torch.float32)
    if signed:
        sign = 1 - 2 * (hash_u32_torch(k, sign_seed) & 1)
        v = v * sign.to(torch.float32)
    return torch.nonzero(monitored).squeeze(1), sub_pkt, col, v


def sketch_update_ref(keys: torch.Tensor, vals: torch.Tensor,
                      ts: torch.Tensor, *, width: int, n_sub: int,
                      log2_te: int, col_seed: int, sign_seed: int,
                      sub_seed: int, signed: bool, level: int = 0,
                      mitigation: bool = False) -> torch.Tensor:
    """``(n_sub, width)`` f32 counters of one fragment epoch, on the
    device of its inputs: one ``index_put_(accumulate=True)``."""
    live = torch.nonzero(vals != 0).squeeze(1)       # skip padding packets
    sel, sub, col, v = row_contrib(
        keys[live], vals[live], ts[live], col_seed=col_seed,
        sign_seed=sign_seed, sub_seed=sub_seed, width=width, n_sub=n_sub,
        log2_n_sub=n_sub.bit_length() - 1, log2_te=log2_te, signed=signed,
        level=level if level else None, mit=1 if mitigation else None)
    out = torch.zeros((n_sub, width), dtype=torch.float32,
                      device=keys.device)
    out.index_put_((sub[sel], col[sel]), v[sel], accumulate=True)
    return out
