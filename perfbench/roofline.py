"""Peaks of the card and the bytes the update kernel B1 must move.

Peaks: NVIDIA's data sheet for the H100 SXM (80 GB HBM3) at its full
700 W power limit; a roofline share is stated against them, with the
card's power limit beside it.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12

#: B1's kernel, as the profiler names it.
B1_KERNEL = "fleet_ragged_kernel"

PACKET_BYTES = 12      # a uint32 key, a float32 value, a uint32 timestamp
PARAM_ROW_BYTES = 32   # eight int32 parameters of an (epoch, row)
COUNTER_BYTES = 4      # one float32 counter


def b1_bytes(events: int, param_rows: int, counters_touched: int) -> int:
    """The least traffic of B1 over a set of launches: every packet of the
    stream read once (UnivMon reads a packet once for all its level rows),
    every parameter row read once, and every counter the packets reach
    written once.  The blk padding and the zero fill of the output are the
    program's layout, not what the update needs, so they are not counted;
    a counter whose signed sum cancels to zero is not counted either."""
    return (PACKET_BYTES * events + PARAM_ROW_BYTES * param_rows
            + COUNTER_BYTES * counters_touched)


def roofline_pct(nbytes: float, kernel_s: float) -> float:
    """Share of the memory roofline: the least time at full bandwidth over
    the measured kernel time, in percent."""
    return 100.0 * nbytes / HBM_BYTES_PER_S / kernel_s
