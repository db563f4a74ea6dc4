"""LCP tables (LCPTable.h role): adjacent LCPs + llcp/rlcp vs brute force."""

import numpy as np

from blasr_jax.index.lcp import adjacent_lcp, build_lr_lcp
from blasr_jax.index.suffix_array import build_suffix_array


def _brute_lcp(g, i, j):
    n = 0
    while i + n < len(g) and j + n < len(g) and g[i + n] == g[j + n]:
        n += 1
    return n


def test_adjacent_lcp_matches_bruteforce():
    rng = np.random.default_rng(17)
    # small alphabet forces long LCPs (chunk-crossing runs)
    g = rng.integers(0, 2, 300).astype(np.uint8)
    sa = build_suffix_array(g)
    lcp = adjacent_lcp(g, sa, chunk=4)
    for i in range(len(sa) - 1):
        assert lcp[i] == _brute_lcp(g, int(sa[i]), int(sa[i + 1])), i


def test_lr_lcp_matches_bruteforce():
    rng = np.random.default_rng(19)
    g = rng.integers(0, 3, 200).astype(np.uint8)
    sa = build_suffix_array(g)
    lcp = adjacent_lcp(g, sa)
    llcp, rlcp = build_lr_lcp(lcp)
    n = len(sa)
    # replay the binary-search tree and check each node
    stack = [(0, n - 1)]
    seen = 0
    while stack:
        l, r = stack.pop()
        if r - l <= 1:
            continue
        m = (l + r) // 2
        assert llcp[m] == _brute_lcp(g, int(sa[l]), int(sa[m])), (l, m)
        assert rlcp[m] == _brute_lcp(g, int(sa[m]), int(sa[r])), (m, r)
        seen += 1
        stack.append((l, m))
        stack.append((m, r))
    assert seen > 50
