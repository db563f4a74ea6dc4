"""cmpseq condensing + anchor statistics."""

import numpy as np

from blasr_jax.core.condense import (
    condense, condensed_to_original, expand, original_to_condensed,
)
from blasr_jax.statistics import anchor_stddev, anchor_zscore, expected_anchors


def test_condense_roundtrip():
    rng = np.random.default_rng(1)
    codes = np.repeat(rng.integers(0, 4, 200), rng.integers(1, 6, 200)).astype(np.uint8)
    cond, lengths, starts = condense(codes)
    np.testing.assert_array_equal(expand(cond, lengths), codes)
    assert np.all(cond[1:] != cond[:-1])  # no adjacent duplicates
    # coordinate maps agree
    for i in range(len(cond)):
        o = condensed_to_original(starts, i)
        assert original_to_condensed(starts, o) == i
    assert original_to_condensed(starts, len(codes) - 1) == len(cond) - 1


def test_anchor_statistics_monte_carlo():
    """Closed-form mean/stddev vs simulation (the reference's precomputed
    AnchorDistributionTable role)."""
    rng = np.random.default_rng(2)
    L, p, k = 300, 0.85, 10
    trials = 4000
    errs = rng.random((trials, L)) < (1 - p)
    ok = np.ones((trials, L - k + 1), bool)
    for d in range(k):
        ok &= ~errs[:, d : d + L - k + 1]
    counts = ok.sum(axis=1)
    mu, sd = expected_anchors(L, p, k), anchor_stddev(L, p, k)
    assert abs(counts.mean() - mu) < 0.05 * mu
    assert abs(counts.std() - sd) < 0.15 * sd
    assert abs(anchor_zscore(int(mu), L, p, k)) < 0.5
