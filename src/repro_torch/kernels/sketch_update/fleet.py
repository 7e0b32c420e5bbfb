"""Fleet update: every (epoch, fragment[, level]) row of a window from one
flat CSR packet stream (port of ``repro/kernels/sketch_update/fleet.py``'s
ragged path).

``fleet_update_ragged`` keeps the reference's contract: a flat
``(n_blocks * blk,)`` stream whose non-decreasing ``block_frag`` map names
each block's packet row, an ``(n_rows, N_PARAMS)`` int32 parameter table
with ``n_levels`` virtual rows per packet row, and a
``(n_rows, n_sub_max, width_max)`` f32 result with exact zeros outside
each row's live ``[:n_sub, :width]`` block.

On CUDA tensors it launches the hand-written kernel in
``csrc/fleet_ragged.cu`` (which replaces the TPU's Pallas kernel) and
raises if the launch fails; on CPU tensors it runs
``fleet_update_ragged_ref``, the plain PyTorch version of the same
arithmetic that the tests and ``chip_smoke.py`` hold the kernel to.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...core.hashing import hash_mod_torch, hash_u32_torch
from .kernel import LVL_FIELD_MASK, LVL_SHIFT, SH_SHIFT

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

_MASK32 = 0xFFFFFFFF
_MAX_GRID_Y = 65535


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
    n_rows = params.shape[0]
    if params.ndim != 2 or params.shape[1] != N_PARAMS:
        raise ValueError(f"params must be (n_rows, {N_PARAMS}), got "
                         f"{params.shape}")
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
    k = keys.to(torch.int64)[live] & _MASK32
    t = ts.to(torch.int64)[live] & _MASK32
    v = vals[live]
    prow = block_frag.to(torch.int64)[live // blk]
    L = n_levels
    rows = (prow[:, None] * L + torch.arange(L, device=dev)[None, :]
            ).reshape(-1)
    k = k.repeat_interleave(L)
    t = t.repeat_interleave(L)
    v = v.repeat_interleave(L)
    p = params.to(torch.int64)[rows]
    n_mask = p[:, PARAM_N_SUB] - 1
    sub_pkt = (t >> (log2_te - p[:, PARAM_LOG2_N_SUB])) & n_mask
    sub_flow = hash_u32_torch(k, p[:, PARAM_SUB_SEED]) & n_mask
    monitored = sub_pkt == sub_flow
    if with_mitigation:
        sub2 = (sub_flow + ((n_mask + 1) >> 1)) & n_mask
        single_hop = (t >> SH_SHIFT) != 0
        monitored |= (p[:, PARAM_MIT] != 0) & single_hop & (sub_pkt == sub2)
    if n_levels > 1:
        monitored &= ((t >> LVL_SHIFT) & LVL_FIELD_MASK) >= p[:, PARAM_LEVEL]
    col = hash_mod_torch(k, p[:, PARAM_COL_SEED], p[:, PARAM_WIDTH])
    if signed:
        sign = 1 - 2 * (hash_u32_torch(k, p[:, PARAM_SIGN_SEED]) & 1)
        v = v * sign.to(torch.float32)
    sel = torch.nonzero(monitored).squeeze(1)
    out.index_put_((rows[sel], sub_pkt[sel], col[sel]), v[sel],
                   accumulate=True)
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ..build import load

    lib = load("fleet_ragged")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fleet_ragged_launch.argtypes = [vp] * 6 + [ci] * 10 + [vp]
    lib.fleet_ragged_launch.restype = ci
    lib.fleet_ragged_max_smem.argtypes = [ctypes.POINTER(ci)]
    lib.fleet_ragged_max_smem.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _max_smem(device_index: int) -> int:
    del device_index  # the C query reads the current device
    n = ctypes.c_int(0)
    err = _lib().fleet_ragged_max_smem(ctypes.byref(n))
    if err:
        raise RuntimeError(f"cudaDeviceGetAttribute failed with error {err}")
    return n.value


def launch_w_blk(n_sub_max: int, width_max: int, smem_bytes: int) -> int:
    """Columns per CTA: the largest power of two whose ``n_sub_max x
    w_blk`` f32 tile fits the shared-memory limit, capped at the width's
    power-of-two ceiling."""
    w = 1
    cap = 1 << max(int(width_max) - 1, 0).bit_length()
    while w * 2 <= cap and n_sub_max * w * 2 * 4 <= smem_bytes:
        w *= 2
    if n_sub_max * w * 4 > smem_bytes:
        raise ValueError(f"n_sub_max={n_sub_max} does not fit one column "
                         f"in {smem_bytes} B of shared memory")
    return w


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
    from ...device import resolve_device

    tensors = [x for x in (keys, vals, ts, params, block_frag)
               if isinstance(x, torch.Tensor)]
    dev = tensors[0].device if tensors else resolve_device(device)
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"inputs on {dev} but device={device!r}")
    params_h = (params.cpu().numpy() if isinstance(params, torch.Tensor)
                else np.asarray(params, np.int32))
    bf_h = (block_frag.cpu().numpy() if isinstance(block_frag, torch.Tensor)
            else np.asarray(block_frag, np.int32))
    n_packets = int(keys.shape[0])
    _validate(params_h, bf_h, n_packets, n_sub_max=n_sub_max,
              width_max=width_max, log2_te=log2_te, blk=blk,
              n_levels=n_levels)
    keys = _as_int32_bits(keys, dev)
    ts = _as_int32_bits(ts, dev)
    vals = _as_tensor(vals, torch.float32, np.float32, dev)
    params = _as_tensor(params, torch.int32, np.int32, dev)
    block_frag = _as_tensor(block_frag, torch.int32, np.int32, dev)
    for name, x in (("keys", keys), ("vals", vals), ("ts", ts),
                    ("params", params), ("block_frag", block_frag)):
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, expected {dev}")
    if keys.ndim != 1 or vals.shape != keys.shape or ts.shape != keys.shape:
        raise ValueError("keys, vals and ts must be flat and of one length")
    kw = dict(n_sub_max=n_sub_max, width_max=width_max, log2_te=log2_te,
              signed=signed, blk=blk, n_levels=n_levels,
              with_mitigation=with_mitigation)
    if dev.type == "cpu":
        return fleet_update_ragged_ref(keys, vals, ts, params, block_frag,
                                       **kw)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch(keys.contiguous(), vals.contiguous(), ts.contiguous(),
                   params.contiguous(), block_frag.contiguous(), **kw)


def _launch(keys, vals, ts, params, block_frag, *, n_sub_max, width_max,
            log2_te, signed, blk, n_levels, with_mitigation):
    dev = keys.device
    n_rows = params.shape[0]
    out = torch.empty((n_rows, n_sub_max, width_max), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    n_prow = n_rows // n_levels
    # Each packet row's first block, derived on the device from the
    # non-decreasing map (validated on the host above).
    row_start = torch.searchsorted(
        block_frag, torch.arange(n_prow + 1, dtype=torch.int32, device=dev)
    ).to(torch.int32)
    with torch.cuda.device(dev):
        w_blk = launch_w_blk(n_sub_max, width_max, _max_smem(dev.index or 0))
        if -(-width_max // w_blk) > _MAX_GRID_Y:
            raise ValueError(f"width_max={width_max} needs more than "
                             f"{_MAX_GRID_Y} width blocks of {w_blk}")
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().fleet_ragged_launch(
            keys.data_ptr(), vals.data_ptr(), ts.data_ptr(),
            params.data_ptr(), row_start.data_ptr(), out.data_ptr(),
            n_rows, n_levels, n_sub_max, width_max, w_blk, blk, log2_te,
            int(signed), int(n_levels > 1), int(with_mitigation), stream)
    if err:
        raise RuntimeError(f"fleet_ragged kernel launch failed: CUDA error "
                           f"{err}")
    fleet_update_ragged.launches += 1
    return out


#: Kernel launches made by ``fleet_update_ragged`` (CUDA tensors only).
fleet_update_ragged.launches = 0
