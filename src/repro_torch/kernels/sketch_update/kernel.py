"""Numerical contract, packed-timestamp layout and launch helpers shared
by the update kernels (the constants of
``repro/kernels/sketch_update/kernel.py``).

The TPU module's value modes, VMEM geometry selector and lane factoring
have no counterpart here.  Every CUDA kernel is one packet-parallel pass
without a shared-memory tile, and each wrapper cuts the packet stream
itself (``fleet.ragged_geometry``, ``fleet.dense_geometry``,
``ops.single_geometry``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

#: f32 accumulates integers exactly while |counter| stays below this, so
#: the order of the kernel's atomic adds cannot change a bit.
EXACT_BOUND = 1 << 24

# Packed-ts field layout (UnivMon / §4.4 on the fleet).  The kernels read
# only timestamp bits [log2_te - log2(n), log2_te), so the packer
# (``core.fleet.fold_packet_flags``) masks ts to its low ``log2_te`` bits
# and folds per-packet metadata into the high bits of the uint32 word:
#   * bits [LVL_SHIFT, LVL_SHIFT+5): the key's UnivMon level id — a level
#     row ``l`` monitors the packet iff ``lvl >= l``;
#   * bit SH_SHIFT: the §4.4 single-hop flag.
# Hence UnivMon needs log2_te <= LVL_SHIFT and n_levels <= 32, and
# mitigation alone log2_te <= SH_SHIFT.
LVL_SHIFT = 24
LVL_FIELD_MASK = 0x1F
SH_SHIFT = 31


def check_output_peak(peak: float) -> None:
    """Enforce the f32 exact-integer contract on a counter peak."""
    if peak >= EXACT_BOUND:
        raise OverflowError(
            f"counter magnitude {peak:.3g} exceeds the f32 exact-integer "
            "range (2^24); shorten the epoch or split the stream")


# --- what the CUDA wrappers share ------------------------------------------


def kernel_lib(name: str, *launch_argtypes,
               symbol: Optional[str] = None) -> ctypes.CDLL:
    """Library ``name`` (``kernels.build.SOURCES``), built on first use,
    with its launch function ``symbol`` (default ``<name>_launch``)
    declared to take ``launch_argtypes`` and return the CUDA error code.
    ``build.load`` is the one cache, so clearing it makes the next launch
    load the library again."""
    from ..build import load

    lib = load(name)
    launch = getattr(lib, symbol or f"{name}_launch")
    if launch.argtypes is None:         # first use of this library object
        launch.argtypes = list(launch_argtypes)
        launch.restype = ctypes.c_int
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def pad_to(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x`` padded with zeros along its last axis to a multiple of ``m``
    (the value-0 padding contract: a padding packet adds nothing)."""
    p = (-x.shape[-1]) % m
    if p == 0:
        return x
    return torch.nn.functional.pad(x, (0, p))
