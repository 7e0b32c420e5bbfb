"""Frozen copy of the DiSketch hash families, in numpy uint32 arithmetic.

The yardstick's own copy: a later change to the program's hashing must not
move the reference it is judged by.  uint32 overflow wraps, as in the
paper's switch arithmetic, and the column hash keeps Lemire's fast range
in two 16-bit limbs *with its uint32 wrap*: for a width above 65 536 the
product ``hi * mod`` wraps, so wide rows reach only part of their columns.
The counters the program must produce are defined with that wrap.
"""
from __future__ import annotations

import numpy as np

_M1 = np.uint32(0x7FEB352D)
_M2 = np.uint32(0x846CA68B)
_SEED_MULT = np.uint32(2654435769)   # floor(2^32 / golden ratio)


def mix32(x) -> np.ndarray:
    """splitmix32 finalizer on uint32."""
    x = np.asarray(x).astype(np.uint32)
    x = (x ^ (x >> np.uint32(16))) * _M1
    x = (x ^ (x >> np.uint32(15))) * _M2
    return x ^ (x >> np.uint32(16))


def hash_u32(keys, seed) -> np.ndarray:
    keys = np.asarray(keys).astype(np.uint32)
    seed = np.asarray(seed).astype(np.uint32)
    return mix32(keys * _SEED_MULT + seed)


def hash_mod(keys, seed, mod) -> np.ndarray:
    """``[0, mod)`` by the fast range in 16-bit limbs (wraps above 2^16)."""
    h = hash_u32(keys, seed)
    mod_u = np.asarray(mod).astype(np.uint32)
    hi = h >> np.uint32(16)
    lo = h & np.uint32(0xFFFF)
    t = (hi * mod_u) + ((lo * mod_u) >> np.uint32(16))
    return (t >> np.uint32(16)).astype(np.int64)


def hash_pow2(keys, seed, n) -> np.ndarray:
    """``[0, n)`` for a power-of-two ``n``: the flow's subepoch."""
    h = hash_u32(keys, seed)
    return (h & (np.asarray(n).astype(np.uint32) - np.uint32(1))
            ).astype(np.int64)


def hash_sign(keys, seed) -> np.ndarray:
    """Count Sketch sign, +1 or -1."""
    return 1 - 2 * (hash_u32(keys, seed) & np.uint32(1)).astype(np.int64)


def level_of(keys, seed, n_levels: int) -> np.ndarray:
    """UnivMon level of each key: the number of trailing one bits of its
    ``n_levels - 1`` sampling bits (level 0 sees every key)."""
    bits = hash_u32(keys, seed) & np.uint32((1 << (n_levels - 1)) - 1)
    lvl = np.zeros(bits.shape, np.int64)
    alive = np.ones(bits.shape, bool)
    for b in range(n_levels - 1):
        alive &= ((bits >> np.uint32(b)) & np.uint32(1)).astype(bool)
        lvl += alive
    return lvl
