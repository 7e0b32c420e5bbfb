"""Universal hash families used by all sketches (port of
``repro/core/hashing.py``).

Two bit-identical forms of the same uint32 arithmetic:

* numpy (``mix32``, ``hash_u32``, ``hash_mod``, ...) for the host packer
  and the host query oracle — uint32 overflow wraps, as in the reference;
* torch (``*_torch``) for the device query plane.  PyTorch cannot shift or
  add ``uint32`` tensors on every backend, so values are carried in int64
  and every step is masked to 32 bits.  Products are split into 16-bit
  limbs so no intermediate leaves the int64 range.

The column hash keeps the reference's Lemire fast-range in 16-bit limbs
*including its uint32 wrap*: for ``mod > 65536`` the product ``hi * mod``
overflows and wraps, so widths above 65536 reach only part of their
columns.  The port reproduces that bit for bit (the CUDA update kernel
does the same in ``uint32_t``), because the counters must match the
reference's exactly.

``seed``/``mod``/``n`` may be scalars or arrays broadcast against ``keys``.
"""
from __future__ import annotations

import numpy as np
import torch

# Distinct odd constants for the avalanche mixer (splitmix32 finalizer).
_M1 = np.uint32(0x7FEB352D)
_M2 = np.uint32(0x846CA68B)
# Large odd multiplier for seeding (Knuth): floor(2^32 / golden_ratio).
_SEED_MULT = np.uint32(2654435769)

_MASK32 = 0xFFFFFFFF


# --- numpy (host) ----------------------------------------------------------


def mix32(x):
    """Avalanche-mix a uint32 array (splitmix32 finalizer)."""
    x = np.asarray(x).astype(np.uint32)
    x = (x ^ (x >> np.uint32(16))) * _M1
    x = (x ^ (x >> np.uint32(15))) * _M2
    return x ^ (x >> np.uint32(16))


def hash_u32(keys, seed):
    """2-universal-style hash of ``keys`` (uint32) under ``seed`` -> uint32."""
    keys = np.asarray(keys).astype(np.uint32)
    seed = np.asarray(seed).astype(np.uint32)
    return mix32(keys * _SEED_MULT + seed)


def hash_mod(keys, seed, mod):
    """Hash of ``keys`` into ``[0, mod)`` by Lemire's fast range in two
    16-bit limbs of uint32 arithmetic (wraps for ``mod > 65536``, see the
    module doc)."""
    h = hash_u32(keys, seed)
    mod_u = np.asarray(mod).astype(np.uint32)
    hi = h >> np.uint32(16)
    lo = h & np.uint32(0xFFFF)
    t = (hi * mod_u) + ((lo * mod_u) >> np.uint32(16))
    return (t >> np.uint32(16)).astype(np.int32)


def hash_pow2(keys, seed, n):
    """Hash of ``keys`` into ``[0, n)`` for power-of-two ``n`` (subepochs)."""
    h = hash_u32(keys, seed)
    return (h & (np.asarray(n).astype(np.uint32) - np.uint32(1))
            ).astype(np.int32)


def hash_sign(keys, seed):
    """Count-Sketch sign hash: +1/-1 (int32)."""
    h = hash_u32(keys, seed)
    return np.int32(1) - np.int32(2) * (h & np.uint32(1)).astype(np.int32)


def hash_bits(keys, seed, nbits: int):
    """``nbits`` independent sampling bits per key (UnivMon levels)."""
    return hash_u32(keys, seed) & np.uint32((1 << nbits) - 1)


def level_of(keys, seed, n_levels: int):
    """UnivMon level membership: the deepest level each key belongs to,
    in ``[0, n_levels)`` (level 0 sees the full stream)."""
    bits = hash_bits(keys, seed, n_levels - 1)
    inv = (~bits) & np.uint32((1 << (n_levels - 1)) - 1)
    lowest = inv & (np.uint32(0) - inv)
    lvl = np.where(
        inv == 0, np.int32(n_levels - 1),
        np.log2(np.maximum(lowest.astype(np.float64), 1.0)).astype(np.int32))
    return lvl.astype(np.int32)


# --- torch (device) --------------------------------------------------------


def _u32(x) -> torch.Tensor:
    """An int64 tensor holding the uint32 value of ``x`` (an int64/int32
    tensor, or anything ``torch.as_tensor`` takes)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, np.int64))
    return x.to(torch.int64) & _MASK32


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2^32`` for uint32 values held in int64, computed in
    16-bit limbs of ``a`` so no product exceeds 2^48."""
    a_hi = a >> 16
    a_lo = a & 0xFFFF
    return ((((a_hi * b) & 0xFFFF) << 16) + a_lo * b) & _MASK32


def mix32_torch(x: torch.Tensor) -> torch.Tensor:
    x = _u32(x)
    x = _mul32(x ^ (x >> 16), int(_M1))
    x = _mul32(x ^ (x >> 15), int(_M2))
    return x ^ (x >> 16)


def hash_u32_torch(keys, seed) -> torch.Tensor:
    """int64 twin of ``hash_u32``.  A Python-int ``seed`` is added as a
    scalar (no host-to-device copy)."""
    keys = _u32(keys)
    seed = seed & _MASK32 if isinstance(seed, int) else \
        _u32(seed).to(keys.device)
    return mix32_torch((_mul32(keys, int(_SEED_MULT)) + seed) & _MASK32)


def hash_mod_torch(keys, seed, mod) -> torch.Tensor:
    """int64 twin of ``hash_mod`` (uint32 wrap included)."""
    h = hash_u32_torch(keys, seed)
    mod_u = _u32(mod).to(h.device)
    hi = h >> 16
    lo = h & 0xFFFF
    t = ((hi * mod_u) + (((lo * mod_u) & _MASK32) >> 16)) & _MASK32
    return t >> 16


def hash_pow2_torch(keys, seed, n) -> torch.Tensor:
    h = hash_u32_torch(keys, seed)
    return h & (_u32(n).to(h.device) - 1)


def hash_sign_torch(keys, seed) -> torch.Tensor:
    return 1 - 2 * (hash_u32_torch(keys, seed) & 1)


def level_of_torch(keys, seed: int, n_levels: int) -> torch.Tensor:
    """int64 twin of ``level_of``, in integer steps alone: the count of
    trailing ones among the key's ``n_levels - 1`` sampling bits (where
    ``level_of`` finds the lowest set bit of their complement)."""
    bits = hash_u32_torch(keys, seed)
    lvl = torch.zeros_like(bits)
    run = torch.ones_like(bits, dtype=torch.bool)
    for b in range(n_levels - 1):
        run &= ((bits >> b) & 1).bool()
        lvl += run
    return lvl
