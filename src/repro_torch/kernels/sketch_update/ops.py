"""Public wrapper of the single-fragment sketch update (port of
``repro/kernels/sketch_update/ops.py``): padding, dispatch and the
output-side overflow guard.

A sketch update is a histogram: ``counters[sub(p), col(p)] += val(p)``
for every monitored packet ``p`` of one fragment epoch.  On CUDA tensors
``sketch_update`` launches the hand-written kernel in
``csrc/sketch_update.cu`` (kernel B2, which replaces the TPU's Pallas
kernel) and raises if the launch fails; on CPU tensors, or with
``backend="ref"``, it runs ``ref.sketch_update_ref``, the plain PyTorch
version the tests and ``chip_smoke.py`` hold the kernel to.

Padding contract: packets are padded to a multiple of ``blk`` and of 4
(the kernel's 16-byte load) with ``value = 0`` entries, which contribute
nothing.  Numerical contract: counters are f32 sums of integers, exact
while ``|counter| < 2^24``, which the wrapper enforces
(``check_overflow``), as the reference does.
The TPU module's ``value_mode``, ``w_blk`` and ``interpret`` knobs have no
counterpart: kernel B2 is one packet-parallel pass over the stream
(``single_geometry``), as the fleet kernels B1 and B3 are.
"""
from __future__ import annotations

import ctypes
import math
import torch

from .fleet import (SLOTS_PER_THREAD, _aligned, _grid, input_device,
                    packet_tensors)
from .kernel import check_launch, check_output_peak, kernel_lib, pad_to
from .ref import sketch_update_ref

_VP, _CI, _CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_VP] * 4 + [_CLL] + [_CI] * 11 + [_VP]
#: Threads of a B2 CTA (``kThreads`` in ``csrc/sketch_update.cu``); each
#: takes 4 packet slots (one 16-byte load each of keys, values and
#: timestamps), so a CTA takes 256 slots and a 32 768-slot fragment of the
#: §6.1 epoch spreads over 128 CTAs (~1% faster there than 256-thread CTAs
#: on the H100; PERF.md).
CTA_THREADS = 64


def _guard_peak(out: torch.Tensor, check_overflow: bool) -> torch.Tensor:
    """Output-side exactness guard (the fleet runner's peak check)."""
    if check_overflow and out.numel():
        check_output_peak(float(out.abs().max()))
    return out


def sketch_update(keys, vals, ts, *, width: int, n_sub: int, log2_te: int,
                  col_seed: int, sign_seed: int, sub_seed: int,
                  signed: bool = True, backend: str = "cuda", blk: int = 256,
                  level: int = 0, mitigation: bool = False,
                  check_overflow: bool = True, device=None) -> torch.Tensor:
    """All subepoch-record counters of one fragment epoch.

    Args:
      keys/ts: ``(P,)`` uint32 words — numpy uint32, or int32 tensors with
        the same bits.  ``ts`` carries the packer's folded high bits when
        ``level``/``mitigation`` are used (``core.fleet.fold_packet_flags``).
      vals: ``(P,)`` values (0 for padding).
      backend: ``"cuda"`` launches kernel B2 on CUDA tensors (CPU tensors
        run the plain version); ``"ref"`` runs the plain version wherever
        the tensors are.
      level: UnivMon level row (0: no level term); ``mitigation``: the
        §4.4 second-subepoch term.
      device: where numpy inputs go (default ``cuda``).

    Returns ``(n_sub, width)`` float32 counters on that device; raises
    ``OverflowError`` past the f32 exact-integer range unless
    ``check_overflow=False``.
    """
    if backend not in ("cuda", "ref"):
        raise ValueError(f"unknown backend {backend!r}; expected 'cuda' or "
                         "'ref'")
    if n_sub < 1 or n_sub & (n_sub - 1):
        raise ValueError(f"n_sub must be a power of two, got {n_sub}")
    if not 0 <= n_sub.bit_length() - 1 <= log2_te <= 31:
        raise ValueError(f"need log2(n_sub) <= log2_te <= 31, got n_sub="
                         f"{n_sub}, log2_te={log2_te}")
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    dev = input_device(device, keys, vals, ts)
    keys, vals, ts = (pad_to(x, math.lcm(blk, SLOTS_PER_THREAD)) for x in
                      packet_tensors(keys, vals, ts, dev, ndim=1))
    kw = dict(width=width, n_sub=n_sub, log2_te=log2_te, col_seed=col_seed,
              sign_seed=sign_seed, sub_seed=sub_seed, signed=signed,
              level=level, mitigation=mitigation)
    if backend == "ref" or dev.type == "cpu":
        out = sketch_update_ref(keys, vals, ts, **kw)
    else:
        out = _launch(_aligned(keys), _aligned(vals), _aligned(ts), **kw)
    return _guard_peak(out, check_overflow)


def single_geometry(n_packets: int) -> int:
    """Kernel B2's grid.  Thread ``i`` of CTA ``c`` loads slots
    ``[4 q, 4 q + 4)``, ``q = c * CTA_THREADS + i``; the grid covers the
    stream's ``ceil(n_packets / 4)`` loads, and lanes past them hold
    zeros."""
    n_quads = -(-n_packets // SLOTS_PER_THREAD)
    return _grid(-(-n_quads // CTA_THREADS))


def _launch(keys, vals, ts, *, width, n_sub, log2_te, col_seed, sign_seed,
            sub_seed, signed, level, mitigation):
    """Launch kernel B2 on 16-byte aligned streams whose length is a
    multiple of 4 (``sketch_update`` pads and aligns them)."""
    dev = keys.device
    n_packets = keys.shape[0]
    if n_packets % SLOTS_PER_THREAD:
        raise ValueError(f"{n_packets} packets are not a multiple of "
                         f"{SLOTS_PER_THREAD} (one 16-byte load)")
    grid = single_geometry(n_packets)
    if grid == 0:   # no packet slots
        return torch.zeros((n_sub, width), dtype=torch.float32, device=dev)
    out = torch.empty((n_sub, width), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        lib = kernel_lib("sketch_update", *_ARGS)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sketch_update_launch(
            keys.data_ptr(), vals.data_ptr(), ts.data_ptr(), out.data_ptr(),
            n_packets // SLOTS_PER_THREAD, grid, width, n_sub,
            int(math.log2(n_sub)), log2_te, int(col_seed), int(sign_seed),
            int(sub_seed), int(level), int(mitigation), int(signed),
            stream)
    check_launch(err, "sketch_update")
    sketch_update.launches += 1
    return out


#: Kernel launches made by ``sketch_update`` (CUDA tensors, backend
#: ``"cuda"`` only).
sketch_update.launches = 0
