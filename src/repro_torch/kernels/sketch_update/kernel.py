"""Numerical contract and packed-timestamp layout shared by the update
kernels (the constants of ``repro/kernels/sketch_update/kernel.py``).

The TPU module's value modes, VMEM geometry selector and lane factoring
have no counterpart here: the CUDA wrapper picks its own launch geometry
(``fleet.py``).
"""
from __future__ import annotations

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
