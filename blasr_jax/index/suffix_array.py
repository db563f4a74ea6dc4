"""Suffix-array construction (L2, host side).

Role of reference ``common/datastructures/suffixarray/SuffixArray.h`` (1175
LoC: Larsson-Sadakane / Karkkainen / Manber-Myers builders + prefix lookup
table) and the ``sawriter`` tool (alignment/SAWriter.cpp).

Design departure: instead of porting a pointer-based qsufsort, construction
is a fully vectorized numpy prefix-doubling sort (Manber-Myers by rank
doubling with lexsort) — O(n log n) bulk array passes that also run well
under jax on CPU. Exactness is what matters here (index build is offline);
a C++ SA-IS builder can replace this for very large genomes.

Suffix order convention matches the reference: the (virtual) past-the-end
suffix is smallest, so a shorter suffix sorts before any longer suffix that
has it as a prefix.
"""

from __future__ import annotations

import numpy as np


def build_suffix_array(codes: np.ndarray) -> np.ndarray:
    """Return int64 suffix array of ``codes`` (uint8 alphabet).

    sa[i] = start position of the i-th smallest suffix. Uses the native
    SA-IS builder (blasr_jax/native, linear time) when available; falls
    back to the numpy prefix-doubling sort below.
    """
    n = int(len(codes))
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if n == 1:
        return np.zeros(1, dtype=np.int64)
    from blasr_jax import native

    sa = native.sais(codes)
    if sa is not None:
        return sa
    rank = codes.astype(np.int64)
    k = 1
    while True:
        key2 = np.zeros(n, dtype=np.int64)
        key2[: n - k] = rank[k:] + 1  # 0 = past-the-end (smallest)
        order = np.lexsort((key2, rank))
        r1 = rank[order]
        r2 = key2[order]
        changed = np.empty(n, dtype=bool)
        changed[0] = True
        changed[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        new_rank_sorted = np.cumsum(changed) - 1
        if new_rank_sorted[-1] == n - 1:
            return order.astype(np.int64)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = new_rank_sorted
        k <<= 1
        if k >= n:
            # ranks must be distinct once k >= n
            return order.astype(np.int64)


def build_suffix_array_naive(codes: np.ndarray) -> np.ndarray:
    """Brute-force oracle for tests (O(n^2 log n))."""
    n = len(codes)
    suffixes = [tuple(codes[i:]) for i in range(n)]
    return np.asarray(sorted(range(n), key=lambda i: suffixes[i]), dtype=np.int64)
