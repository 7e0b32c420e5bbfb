"""Parity of the port's hashes (numpy and int64 torch) with the JAX
package's ``repro.core.hashing`` — exact, including the uint32 wrap of the
Lemire column hash for widths above 65536."""
import numpy as np
import pytest
import torch

from repro.core import hashing as RH
from repro_torch.core import hashing as TH

N_KEYS = 100_000
WIDTHS = [1000, 65536, 70000, 262144]


@pytest.fixture(scope="module")
def keys_seeds():
    rng = np.random.default_rng(12)
    keys = rng.integers(0, 2 ** 32, N_KEYS, dtype=np.uint64).astype(np.uint32)
    seeds = rng.integers(0, 2 ** 31, N_KEYS)
    return keys, seeds


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


@pytest.mark.parametrize("width", WIDTHS)
def test_hash_mod_matches_reference(keys_seeds, width):
    keys, seeds = keys_seeds
    ref = RH.hash_mod(keys, seeds, width)          # broadcast seeds
    np.testing.assert_array_equal(TH.hash_mod(keys, seeds, width), ref)
    np.testing.assert_array_equal(
        TH.hash_mod_torch(_t(keys), _t(seeds), width).numpy(), ref)
    # scalar seed, broadcast (rows, 1) x (1, K) mods as the query plane
    # hashes one key batch under every row's width
    mods = np.array([[width], [width // 3 + 1]])
    ref2 = RH.hash_mod(keys[None, :1000], 77, mods)
    np.testing.assert_array_equal(
        TH.hash_mod_torch(_t(keys[None, :1000]), 77, _t(mods)).numpy(), ref2)


def test_hash_mod_wraps_above_65536_like_reference(keys_seeds):
    """The reference's limb product wraps in uint32: a 262144-wide row
    reaches only a quarter of its columns, and the port must agree."""
    keys, _ = keys_seeds
    cols = TH.hash_mod(keys, 12345, 262144)
    assert cols.max() < 65536
    np.testing.assert_array_equal(cols, RH.hash_mod(keys, 12345, 262144))


@pytest.mark.parametrize("n", [1, 2, 16, 1024])
def test_hash_pow2_sign_u32_match_reference(keys_seeds, n):
    keys, seeds = keys_seeds
    np.testing.assert_array_equal(TH.hash_pow2(keys, seeds, n),
                                  RH.hash_pow2(keys, seeds, n))
    np.testing.assert_array_equal(
        TH.hash_pow2_torch(_t(keys), _t(seeds), n).numpy(),
        RH.hash_pow2(keys, seeds, n))
    np.testing.assert_array_equal(TH.hash_sign(keys, seeds + n),
                                  RH.hash_sign(keys, seeds + n))
    np.testing.assert_array_equal(
        TH.hash_sign_torch(_t(keys), _t(seeds + n)).numpy(),
        RH.hash_sign(keys, seeds + n))
    np.testing.assert_array_equal(
        TH.hash_u32_torch(_t(keys), _t(seeds + n)).numpy(),
        RH.hash_u32(keys, seeds + n).astype(np.int64))
    np.testing.assert_array_equal(TH.mix32(keys + np.uint32(n)),
                                  RH.mix32(keys + np.uint32(n)))


@pytest.mark.parametrize("n_levels", [2, 4, 16, 32])
def test_level_of_matches_reference(keys_seeds, n_levels):
    keys, _ = keys_seeds
    ref = RH.level_of(keys, 7777, n_levels)
    np.testing.assert_array_equal(TH.level_of(keys, 7777, n_levels), ref)
