import numpy as np
import pytest

from blasr_jax.index.suffix_array import build_suffix_array, build_suffix_array_naive


@pytest.mark.parametrize("n", [0, 1, 2, 5, 17, 100, 257])
def test_sa_matches_naive(n):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    assert np.array_equal(build_suffix_array(codes), build_suffix_array_naive(codes))


def test_sa_repetitive():
    # heavy repeats stress the doubling loop
    codes = np.tile(np.array([0, 1, 0, 1, 2], dtype=np.uint8), 100)
    assert np.array_equal(build_suffix_array(codes), build_suffix_array_naive(codes))


def test_sa_homopolymer():
    codes = np.zeros(300, dtype=np.uint8)
    sa = build_suffix_array(codes)
    # all-A: shortest suffix first
    assert np.array_equal(sa, np.arange(299, -1, -1))


def test_sa_is_permutation_large():
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=50000).astype(np.uint8)
    sa = build_suffix_array(codes)
    assert np.array_equal(np.sort(sa), np.arange(50000))
    # spot-check sortedness at random adjacent pairs
    for i in rng.integers(0, 49999, size=200):
        a, b = sa[i], sa[i + 1]
        sfx_a = codes[a : a + 50].tobytes()
        sfx_b = codes[b : b + 50].tobytes()
        assert sfx_a <= sfx_b
