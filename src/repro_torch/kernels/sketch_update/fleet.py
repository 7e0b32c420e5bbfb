"""Fleet update: every (epoch, fragment[, level]) row of a window or epoch
in one launch (port of ``repro/kernels/sketch_update/fleet.py``).

``fleet_update_ragged`` (kernel B1, ``csrc/fleet_ragged.cu``) keeps the
reference's ragged contract: a flat ``(n_blocks * blk,)`` stream whose
non-decreasing ``block_frag`` map names each block's packet row, an
``(n_rows, N_PARAMS)`` int32 parameter table with ``n_levels`` virtual
rows per packet row, and a ``(n_rows, n_sub_max, width_max)`` f32 result
with exact zeros outside each row's live ``[:n_sub, :width]`` block.

``fleet_update`` (kernel B3, ``csrc/fleet_dense.cu``) takes one epoch as
the reference's dense ``(n_frags, p_max)`` rectangle instead, cs/cms only
(the level and §4.4 terms are compiled out, as in the reference).
``fleet_update_loop`` is the loop-of-kernels baseline: one single-fragment
``ops.sketch_update`` (kernel B2) per parameter row.  ``csr_scatter``
(``csrc/csr_scatter.cu``, in B1's library) lays out B1's stream on its
device from a window's staged packets, folding each key's UnivMon level into
its ts as it goes.

On CUDA tensors each wrapper launches its hand-written kernel (which
replaces the TPU's Pallas kernel) and raises if the launch fails; on CPU
tensors it runs the plain PyTorch version of the same arithmetic
(``*_ref``, built on ``ref.row_contrib``) that the tests and
``chip_smoke.py`` hold the kernel to.

B1 and B3 are one packet-parallel pass: the grid spans the packet stream
(``ragged_geometry``: CTAs of ``blocks_per_cta`` stream blocks) or the
rectangle (``dense_geometry``: CTAs of ``CTA_SLOTS``-slot chunks of a
row), each packet is read once per launch, and every monitored packet is
added into a zeroed output with one global atomic add.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ... import obs
from ...core.hashing import level_of_torch
from .kernel import (LVL_FIELD_MASK, LVL_SHIFT, check_launch, kernel_lib,
                     pad_to)
from .ref import row_contrib

# Columns of the per-row int32 parameter table.
PARAM_COL_SEED = 0
PARAM_SIGN_SEED = 1
PARAM_SUB_SEED = 2
PARAM_WIDTH = 3
PARAM_N_SUB = 4
PARAM_LOG2_N_SUB = 5
PARAM_LEVEL = 6   # UnivMon virtual level row id (0 for cs/cms)
PARAM_MIT = 7     # §4.4 single-hop mitigation enabled for this row
N_PARAMS = 8

#: Threads of a B1 / B3 CTA, and the packet slots each takes at a time:
#: one 16-byte load each of keys, values and timestamps.
CTA_THREADS = 256
SLOTS_PER_THREAD = 4
CTA_SLOTS = CTA_THREADS * SLOTS_PER_THREAD
_MAX_GRID_X = 2 ** 31 - 1


def _as_int32_bits(x, device) -> torch.Tensor:
    """uint32 words (keys, packed ts) as an int32 tensor of the same bits:
    PyTorch lacks uint32 arithmetic on some backends, and the kernel reads
    the buffer as ``uint32_t``."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int32:
            raise TypeError(f"expected int32 bit patterns, got {x.dtype}")
        return x
    a = np.require(np.asarray(x).astype(np.uint32).view(np.int32),
                   requirements=("C", "W"))
    return torch.from_numpy(a).to(device)


def _host_i32(x) -> np.ndarray:
    """A small int32 table (params, block map) on the host, for checks."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x, np.int32)


def input_device(device, *xs) -> torch.device:
    """The device a wrapper runs on: its tensor inputs' (which must agree
    with ``device`` when both are given), else ``device`` (default
    ``cuda``) for numpy inputs."""
    from ...device import resolve_device

    tensors = [x for x in xs if isinstance(x, torch.Tensor)]
    dev = tensors[0].device if tensors else resolve_device(device)
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"inputs on {dev} but device={device!r}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_on(dev: torch.device, **tensors) -> None:
    for name, x in tensors.items():
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, expected {dev}")


def packet_tensors(keys, vals, ts, dev: torch.device, ndim: int):
    """keys/vals/ts as the kernels read them on ``dev``: uint32 words as
    int32 bit patterns, values as float32; all of one ``ndim`` shape."""
    keys = _as_int32_bits(keys, dev)
    ts = _as_int32_bits(ts, dev)
    vals = _as_tensor(vals, torch.float32, np.float32, dev)
    _check_on(dev, keys=keys, vals=vals, ts=ts)
    if keys.ndim != ndim or vals.shape != keys.shape \
            or ts.shape != keys.shape:
        raise ValueError(f"keys, vals and ts must be {ndim}-d and of one "
                         "shape")
    return keys, vals, ts


def _as_tensor(x, dtype, np_dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        if x.dtype != dtype:
            raise TypeError(f"expected {dtype}, got {x.dtype}")
        return x
    a = np.require(np.asarray(x, np_dtype), requirements=("C", "W"))
    return torch.from_numpy(a).to(device)


def _validate(params: np.ndarray, block_frag: np.ndarray, n_packets: int, *,
              n_sub_max: int, width_max: int, log2_te: int, blk: int,
              n_levels: int) -> None:
    """Host-side checks of what the kernel trusts: shapes, the CSR map, and
    every row's n_sub / width inside the output it writes."""
    _validate_params(params, n_sub_max=n_sub_max, width_max=width_max,
                     log2_te=log2_te)
    n_rows = params.shape[0]
    if n_levels < 1 or n_rows % n_levels:
        raise ValueError(f"{n_rows} rows are not a multiple of "
                         f"n_levels={n_levels}")
    nb = block_frag.shape[0]
    if n_packets != nb * blk:
        raise ValueError(f"stream of {n_packets} packets is not "
                         f"{nb} blocks of {blk}")
    n_prow = n_rows // n_levels
    if nb:
        steps = np.diff(block_frag.astype(np.int64))
        if (block_frag[0] != 0 or (steps < 0).any() or (steps > 1).any()
                or block_frag[-1] != n_prow - 1):
            raise ValueError("block_frag must be non-decreasing from 0 to "
                             "n_packet_rows - 1 with every packet row "
                             "owning at least one block")
    elif n_prow:
        raise ValueError("every packet row must own at least one block")


def _validate_params(params: np.ndarray, *, n_sub_max: int, width_max: int,
                     log2_te: int) -> None:
    """Every row's n_sub / width inside the output the kernel writes."""
    if params.ndim != 2 or params.shape[1] != N_PARAMS:
        raise ValueError(f"params must be (n_rows, {N_PARAMS}), got "
                         f"{params.shape}")
    n_rows = params.shape[0]
    if not 0 <= log2_te <= 31:
        raise ValueError(f"log2_te={log2_te} outside [0, 31]")
    n = params[:, PARAM_N_SUB].astype(np.int64)
    if n_rows and ((n < 1) | (n & (n - 1)) | (n > n_sub_max)).any():
        raise ValueError("every row's n_sub must be a power of two "
                         f"<= n_sub_max={n_sub_max}")
    if (np.left_shift(1, params[:, PARAM_LOG2_N_SUB].astype(np.int64))
            != n).any() or (params[:, PARAM_LOG2_N_SUB] > log2_te).any():
        raise ValueError("PARAM_LOG2_N_SUB must be log2(n_sub) <= log2_te")
    w = params[:, PARAM_WIDTH].astype(np.int64)
    if n_rows and ((w < 1) | (w > width_max)).any():
        raise ValueError(f"every row's width must lie in [1, {width_max}]")


def fleet_update_ragged_ref(keys: torch.Tensor, vals: torch.Tensor,
                            ts: torch.Tensor, params: torch.Tensor,
                            block_frag: torch.Tensor, *, n_sub_max: int,
                            width_max: int, log2_te: int, signed: bool,
                            blk: int, n_levels: int = 1,
                            with_mitigation: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the ragged update: hash every (packet,
    level) pair, mask, then one ``index_put_(accumulate=True)``.  Runs on
    whatever device its tensors are on; exact because every counter is an
    integer sum below 2^24."""
    dev = keys.device
    n_rows = params.shape[0]
    out = torch.zeros((n_rows, n_sub_max, width_max), dtype=torch.float32,
                      device=dev)
    live = torch.nonzero(vals != 0).squeeze(1)       # skip padding packets
    prow = block_frag.to(torch.int64)[live // blk]
    L = n_levels
    rows = (prow[:, None] * L + torch.arange(L, device=dev)[None, :]
            ).reshape(-1)
    p = params.to(torch.int64)[rows]
    sel, sub, col, v = row_contrib(
        keys[live].repeat_interleave(L), vals[live].repeat_interleave(L),
        ts[live].repeat_interleave(L), **_row_kw(p), log2_te=log2_te,
        signed=signed, level=p[:, PARAM_LEVEL] if n_levels > 1 else None,
        mit=p[:, PARAM_MIT] if with_mitigation else None)
    out.index_put_((rows[sel], sub[sel], col[sel]), v[sel], accumulate=True)
    return out


def _row_kw(p: torch.Tensor) -> dict:
    """``row_contrib``'s hashing parameters from gathered table rows."""
    return dict(col_seed=p[:, PARAM_COL_SEED], sign_seed=p[:, PARAM_SIGN_SEED],
                sub_seed=p[:, PARAM_SUB_SEED], width=p[:, PARAM_WIDTH],
                n_sub=p[:, PARAM_N_SUB], log2_n_sub=p[:, PARAM_LOG2_N_SUB])


_VP, _CI, _CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_RAGGED_ARGS = [_VP] * 6 + [_CLL] + [_CI] * 10 + [_VP]
_DENSE_ARGS = [_VP] * 5 + [_CLL] + [_CI] * 6 + [_VP]


def _grid(n_ctas: int) -> int:
    if n_ctas > _MAX_GRID_X:
        raise ValueError(f"{n_ctas} CTAs exceed CUDA's grid limit of "
                         f"{_MAX_GRID_X}")
    return n_ctas


def ragged_geometry(n_blocks: int, blk: int) -> Tuple[int, int]:
    """Kernel B1's launch: ``(blocks_per_cta, grid)``.  CTA ``c`` walks
    stream blocks ``[c * blocks_per_cta, min((c + 1) * blocks_per_cta,
    n_blocks))``: as many whole blocks as fit ``CTA_SLOTS`` slots (one
    load per thread), and at least one."""
    if blk < 1 or blk % SLOTS_PER_THREAD:
        raise ValueError(f"blk={blk} is not a positive multiple of "
                         f"{SLOTS_PER_THREAD} (one 16-byte load)")
    blocks_per_cta = max(1, CTA_SLOTS // blk)
    return blocks_per_cta, _grid(-(-n_blocks // blocks_per_cta))


def dense_geometry(n_frags: int, p_max: int) -> Tuple[int, int]:
    """Kernel B3's launch: ``(chunks_per_row, grid)``.  CTA ``c`` walks
    slots ``[j * CTA_SLOTS, min((j + 1) * CTA_SLOTS, p_max))`` of row
    ``c // chunks_per_row``, with ``j = c % chunks_per_row``."""
    if p_max % SLOTS_PER_THREAD:
        raise ValueError(f"p_max={p_max} is not a multiple of "
                         f"{SLOTS_PER_THREAD} (one 16-byte load)")
    chunks_per_row = -(-p_max // CTA_SLOTS)
    return chunks_per_row, _grid(n_frags * chunks_per_row)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and at a 16-byte aligned address, as the kernels'
    vector loads need (a fresh allocation is; a view may not be)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def fleet_update_ragged(keys, vals, ts, params, block_frag, *,
                        n_sub_max: int, width_max: int, log2_te: int,
                        signed: bool = True, blk: int = 256,
                        n_levels: int = 1, with_mitigation: bool = False,
                        device=None) -> torch.Tensor:
    """Counters of every param row of a CSR-packed fleet epoch or window.

    Args:
      keys/ts: ``(n_blocks * blk,)`` uint32 words — numpy uint32, or int32
        tensors holding the same bits.
      vals: ``(n_blocks * blk,)`` float32 values (0 for padding).
      params: ``(n_rows, N_PARAMS)`` int32 table; ``n_levels`` consecutive
        virtual level rows per packet row.
      block_frag: ``(n_blocks,)`` int32 non-decreasing block -> packet-row
        map; every packet row owns at least one block (``pack_csr``).
      device: where numpy inputs go (default ``cuda``); tensors stay where
        they are, and all inputs must share one device.

    Returns ``(n_rows, n_sub_max, width_max)`` float32 counters on that
    device.  CUDA tensors launch the kernel (or raise); CPU tensors run
    ``fleet_update_ragged_ref``.
    """
    dev = input_device(device, keys, vals, ts, params, block_frag)
    params_h = _host_i32(params)
    bf_h = _host_i32(block_frag)
    n_packets = int(keys.shape[0])
    _validate(params_h, bf_h, n_packets, n_sub_max=n_sub_max,
              width_max=width_max, log2_te=log2_te, blk=blk,
              n_levels=n_levels)
    host = [not isinstance(x, torch.Tensor)
            for x in (keys, vals, ts, params, block_frag)]
    with obs.span("fleet.upload"):
        keys, vals, ts = packet_tensors(keys, vals, ts, dev, ndim=1)
        params = _as_tensor(params, torch.int32, np.int32, dev)
        block_frag = _as_tensor(block_frag, torch.int32, np.int32, dev)
        obs.add("bytes", sum(t.nbytes for t, h in zip(
            (keys, vals, ts, params, block_frag), host) if h))
    _check_on(dev, params=params, block_frag=block_frag)
    kw = dict(n_sub_max=n_sub_max, width_max=width_max, log2_te=log2_te,
              signed=signed, blk=blk, n_levels=n_levels,
              with_mitigation=with_mitigation)
    if dev.type == "cpu":
        return fleet_update_ragged_ref(keys, vals, ts, params, block_frag,
                                       **kw)
    return _launch(_aligned(keys), _aligned(vals), _aligned(ts),
                   params.contiguous(), block_frag.contiguous(), **kw)


def _launch(keys, vals, ts, params, block_frag, *, n_sub_max, width_max,
            log2_te, signed, blk, n_levels, with_mitigation):
    dev = keys.device
    n_rows = params.shape[0]
    out = torch.zeros((n_rows, n_sub_max, width_max), dtype=torch.float32,
                      device=dev)
    n_blocks = block_frag.shape[0]
    blocks_per_cta, grid = ragged_geometry(n_blocks, blk)
    if grid == 0:   # no stream, hence (validated) no rows
        return out
    with torch.cuda.device(dev):
        lib = kernel_lib("fleet_ragged", *_RAGGED_ARGS)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fleet_ragged_launch(
            keys.data_ptr(), vals.data_ptr(), ts.data_ptr(),
            params.data_ptr(), block_frag.data_ptr(), out.data_ptr(),
            n_blocks, blocks_per_cta, grid, blk, n_levels, n_sub_max,
            width_max, log2_te, int(signed), int(n_levels > 1),
            int(with_mitigation), stream)
    check_launch(err, "fleet_ragged")
    fleet_update_ragged.launches += 1
    return out


#: Kernel launches made by ``fleet_update_ragged`` (CUDA tensors only).
fleet_update_ragged.launches = 0


# --- B1's stream on the card (the CSR scatter) -----------------------------


def csr_scatter_ref(keys: torch.Tensor, vals: torch.Tensor, ts: torch.Tensor,
                    rows: torch.Tensor, block_row: torch.Tensor, *,
                    blk: int, log2_te: int = 0, n_levels: int = 1,
                    level_seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor]:
    """Plain PyTorch version of the CSR scatter: slot ``q`` of block
    ``b = q // blk`` holds staged packet ``src_off[r] + s`` of its row
    ``r = block_row[b]`` while ``s = q - first_blk[r] * blk`` is below
    the row's length, and zeros after; with ``n_levels > 1`` a live slot's
    ts is folded as ``core.fleet.fold_packet_flags`` folds the level."""
    dev = keys.device
    n = block_row.shape[0] * blk
    q = torch.arange(n, device=dev)
    r = block_row[q // blk]
    s = q - rows[2, r] * blk
    live = s < rows[1, r]
    src = (rows[0, r] + s)[live]
    out = []
    for x in (keys, vals, ts):
        o = torch.zeros(n, dtype=x.dtype, device=dev)
        o[live] = x[src]
        out.append(o)
    if n_levels > 1:
        lvl = level_of_torch(keys[src], level_seed, n_levels)
        out[2][live] = ((ts[src].to(torch.int64) & ((1 << log2_te) - 1))
                        | (lvl << LVL_SHIFT)).to(torch.int32)
    return tuple(out)


def csr_scatter(keys, vals, ts, rows, block_row, *, blk: int = 256,
                log2_te: int = 0, n_levels: int = 1, level_seed: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One row group's ``(n_blocks * blk,)`` stream for ``fleet_update_
    ragged``, gathered from a window's staged packets
    (``core.fleet.stage_packets``): the bits ``core.fleet.pack_csr``
    returns for the group's fragments, padding included.

    Args:
      keys/ts: ``(P,)`` int32 tensors of the staged uint32 words.
      vals: ``(P,)`` float32 staged values.
      rows: ``(3, R)`` int64 source offset, length and first block of each
        packet row (``core.fleet.csr_row_tables``).
      block_row: ``(n_blocks,)`` int64 block -> packet-row map.
      All on one device.  The tables are trusted as ``csr_row_tables``
      builds them: reading them back here would make the host wait.
      log2_te/n_levels/level_seed: with ``n_levels > 1`` the staged ts are
        raw, and each live slot's is folded as ``core.fleet.
        fold_packet_flags(..., n_levels=n_levels, level_seed=level_seed)``
        folds it (no §4.4 flag); ``n_levels = 1`` copies them.

    Returns int32 keys, float32 values and int32 ts of ``n_blocks * blk``
    slots on that device.  CUDA tensors launch the scatter kernel
    (``csrc/csr_scatter.cu``, in B1's library) or raise; CPU tensors run
    ``csr_scatter_ref``.
    """
    dev = input_device(None, keys, vals, ts, rows, block_row)
    for name, x, dtype in (("keys", keys, torch.int32),
                           ("vals", vals, torch.float32),
                           ("ts", ts, torch.int32),
                           ("rows", rows, torch.int64),
                           ("block_row", block_row, torch.int64)):
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    _check_on(dev, keys=keys, vals=vals, ts=ts, rows=rows,
              block_row=block_row)
    if keys.ndim != 1 or vals.shape != keys.shape or ts.shape != keys.shape:
        raise ValueError("keys, vals and ts must be 1-d and of one shape")
    if rows.ndim != 2 or rows.shape[0] != 3 or block_row.ndim != 1:
        raise ValueError("rows must be (3, n_rows) and block_row 1-d")
    if blk < 1 or blk % SLOTS_PER_THREAD:
        raise ValueError(f"blk={blk} is not a positive multiple of "
                         f"{SLOTS_PER_THREAD} (one 16-byte store)")
    if not 1 <= n_levels <= LVL_FIELD_MASK + 1:
        raise ValueError(f"n_levels={n_levels} outside [1, "
                         f"{LVL_FIELD_MASK + 1}]")
    if n_levels > 1 and not 0 <= log2_te <= LVL_SHIFT:
        raise ValueError(f"folding levels needs log2_te in [0, {LVL_SHIFT}]"
                         f", got {log2_te}")
    fold = dict(log2_te=log2_te, n_levels=n_levels,
                level_seed=level_seed & 0xFFFFFFFF)
    if dev.type == "cpu":
        return csr_scatter_ref(keys, vals, ts, rows, block_row, blk=blk,
                               **fold)
    return _launch_scatter(*(x.contiguous() for x in
                             (keys, vals, ts, rows, block_row)), blk=blk,
                           **fold)


_SCATTER_ARGS = ([_VP] * 10 + [_CLL] + [_CI] * 2 + [ctypes.c_uint32] * 2
                 + [_CI, _VP])


def _launch_scatter(keys, vals, ts, rows, block_row, *, blk, log2_te,
                    n_levels, level_seed):
    dev = keys.device
    n = block_row.shape[0] * blk
    outs = (torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev))
    n_quads = n // SLOTS_PER_THREAD
    grid = _grid(-(-n_quads // CTA_THREADS))
    if grid == 0:
        return outs
    with torch.cuda.device(dev):
        lib = kernel_lib("fleet_ragged", *_SCATTER_ARGS,
                         symbol="csr_scatter_launch")
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.csr_scatter_launch(
            keys.data_ptr(), vals.data_ptr(), ts.data_ptr(),
            rows[0].data_ptr(), rows[1].data_ptr(), rows[2].data_ptr(),
            block_row.data_ptr(), *(o.data_ptr() for o in outs), n_quads,
            grid, blk, (1 << log2_te) - 1, level_seed, n_levels, stream)
    check_launch(err, "csr_scatter")
    csr_scatter.launches += 1
    return outs


#: Kernel launches made by ``csr_scatter`` (CUDA tensors only).
csr_scatter.launches = 0


# --- dense rectangle (kernel B3) -------------------------------------------


def fleet_update_ref(keys: torch.Tensor, vals: torch.Tensor,
                     ts: torch.Tensor, params: torch.Tensor, *,
                     n_sub_max: int, width_max: int, log2_te: int,
                     signed: bool) -> torch.Tensor:
    """Plain PyTorch version of the dense update: every packet of row ``f``
    hashed under table row ``f`` (no level or §4.4 term), then one
    ``index_put_(accumulate=True)``."""
    n_frags = params.shape[0]
    out = torch.zeros((n_frags, n_sub_max, width_max), dtype=torch.float32,
                      device=keys.device)
    live = torch.nonzero(vals.reshape(-1) != 0).squeeze(1)
    rows = live // max(keys.shape[1], 1)
    p = params.to(torch.int64)[rows]
    sel, sub, col, v = row_contrib(
        keys.reshape(-1)[live], vals.reshape(-1)[live], ts.reshape(-1)[live],
        **_row_kw(p), log2_te=log2_te, signed=signed)
    out.index_put_((rows[sel], sub[sel], col[sel]), v[sel], accumulate=True)
    return out


def fleet_update(keys, vals, ts, params, *, n_sub_max: int, width_max: int,
                 log2_te: int, signed: bool = True, blk: int = 256,
                 device=None) -> torch.Tensor:
    """Counters of every fragment of one fleet epoch from the dense
    rectangle (cs/cms: ``PARAM_LEVEL``/``PARAM_MIT`` are ignored, as the
    reference compiles those terms out).

    Args:
      keys/vals/ts: ``(n_frags, p_max)`` rectangle, row ``f`` fragment
        ``f``'s stream padded with value-0 packets (``FleetPacket
        .densify``); uint32 words as numpy uint32 or int32 bit tensors.
        ``p_max`` is padded here to a multiple of ``blk``.
      params: ``(n_frags, N_PARAMS)`` int32 table (``core.fleet
        .build_params``).
      device: where numpy inputs go (default ``cuda``).

    Returns ``(n_frags, n_sub_max, width_max)`` float32 counters, exact
    zeros outside each fragment's live ``[:n_sub, :width]`` block.  CUDA
    tensors launch kernel B3 (or raise); CPU tensors run
    ``fleet_update_ref``.
    """
    dev = input_device(device, keys, vals, ts, params)
    params_h = _host_i32(params)
    _validate_params(params_h, n_sub_max=n_sub_max, width_max=width_max,
                     log2_te=log2_te)
    keys, vals, ts = (pad_to(x, blk) for x in
                      packet_tensors(keys, vals, ts, dev, ndim=2))
    if keys.shape[0] != params_h.shape[0]:
        raise ValueError(f"{keys.shape[0]} packet rows for "
                         f"{params_h.shape[0]} parameter rows")
    params = _as_tensor(params, torch.int32, np.int32, dev)
    _check_on(dev, params=params)
    kw = dict(n_sub_max=n_sub_max, width_max=width_max, log2_te=log2_te,
              signed=signed)
    if dev.type == "cpu":
        return fleet_update_ref(keys, vals, ts, params, **kw)
    return _launch_dense(_aligned(keys), _aligned(vals), _aligned(ts),
                         params.contiguous(), **kw)


def _launch_dense(keys, vals, ts, params, *, n_sub_max, width_max, log2_te,
                  signed):
    dev = keys.device
    n_frags, p_max = keys.shape
    out = torch.zeros((n_frags, n_sub_max, width_max), dtype=torch.float32,
                      device=dev)
    chunks_per_row, grid = dense_geometry(n_frags, p_max)
    if grid == 0:   # no fragments or no packet slots
        return out
    with torch.cuda.device(dev):
        lib = kernel_lib("fleet_dense", *_DENSE_ARGS)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fleet_dense_launch(
            keys.data_ptr(), vals.data_ptr(), ts.data_ptr(),
            params.data_ptr(), out.data_ptr(), p_max, chunks_per_row, grid,
            n_sub_max, width_max, log2_te, int(signed), stream)
    check_launch(err, "fleet_dense")
    fleet_update.launches += 1
    return out


#: Kernel launches made by ``fleet_update`` (CUDA tensors only).
fleet_update.launches = 0


# --- loop of single-fragment kernels (kernel B2) ---------------------------


def fleet_update_loop(keys, vals, ts, params, *, n_sub_max: int,
                      width_max: int, log2_te: int, signed: bool = True,
                      backend: str = "cuda", blk: int = 256,
                      device=None) -> torch.Tensor:
    """Per-row loop baseline (and oracle): one ``ops.sketch_update`` per
    parameter row, each result written into the stacked layout on the
    device.

    ``keys``/``vals``/``ts`` are ``(n_packet_rows, p)`` rectangles;
    ``params`` has ``n_levels = n_rows / n_packet_rows`` rows per packet
    row, and row ``f * n_levels + l`` re-dispatches packet row ``f`` at its
    own level / §4.4 parameters.  ``backend="cuda"`` launches kernel B2
    per row on CUDA tensors (CPU tensors run its plain version);
    ``backend="ref"`` runs the plain version wherever the tensors are.
    Returns ``(n_rows, n_sub_max, width_max)`` float32 counters.
    """
    from .ops import sketch_update

    dev = input_device(device, keys, vals, ts, params)
    params_h = _host_i32(params)
    _validate_params(params_h, n_sub_max=n_sub_max, width_max=width_max,
                     log2_te=log2_te)
    keys, vals, ts = packet_tensors(keys, vals, ts, dev, ndim=2)
    n_rows = params_h.shape[0]
    if keys.shape[0] == 0 or n_rows % keys.shape[0]:
        raise ValueError(f"{n_rows} parameter rows are not a multiple of "
                         f"{keys.shape[0]} packet rows")
    n_levels = n_rows // keys.shape[0]
    out = torch.zeros((n_rows, n_sub_max, width_max), dtype=torch.float32,
                      device=dev)
    for r in range(n_rows):
        f = r // n_levels
        p = params_h[r]
        width, n_sub = int(p[PARAM_WIDTH]), int(p[PARAM_N_SUB])
        out[r, :n_sub, :width] = sketch_update(
            keys[f], vals[f], ts[f], width=width, n_sub=n_sub,
            log2_te=log2_te, col_seed=int(p[PARAM_COL_SEED]),
            sign_seed=int(p[PARAM_SIGN_SEED]),
            sub_seed=int(p[PARAM_SUB_SEED]), level=int(p[PARAM_LEVEL]),
            mitigation=bool(p[PARAM_MIT]), signed=signed, backend=backend,
            blk=blk)
    return out
