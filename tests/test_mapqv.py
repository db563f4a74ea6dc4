"""Unit tests for map_qv_reference (StoreMapQVs semantics)."""

import numpy as np
import jax.numpy as jnp

from blasr_jax.ops.mapqv import map_qv_reference


def _mq(scores, q_lo, q_hi, nmm, valid=None):
    scores = np.asarray(scores, np.int32)[None, :]
    B, CD = scores.shape
    v = np.ones((B, CD), bool) if valid is None else np.asarray(valid)[None, :]
    lo = np.asarray(q_lo, np.int32)[None, :]
    hi = np.asarray(q_hi, np.int32)[None, :]
    nm = (hi - lo)  # approx: matches fill the span
    nmm_a = np.asarray(nmm, np.int32)[None, :]
    z = np.zeros((B, CD), np.int32)
    out = map_qv_reference(
        jnp.asarray(scores), jnp.asarray(v), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(nm), jnp.asarray(nmm_a), z, z,
    )
    return np.asarray(out)[0]


def test_unique_candidate_gets_254():
    q = _mq([-2000, 0], [0, 0], [500, 0], [0, 0], valid=[True, False])
    assert q[0] == 254


def test_equal_overlapping_competitors_get_low_mapqv():
    """Two identical-quality placements of the same read span: ambiguous,
    mapQV ~ 3 (p = 0.5)."""
    q = _mq([-2000, -2000], [0, 0], [500, 500], [5, 5])
    assert q[0] <= 4 and q[1] <= 4


def test_clear_winner_keeps_high_mapqv():
    """Runner-up with many more mismatches: winner stays confident."""
    q = _mq([-2000, -800], [0, 0], [500, 500], [0, 60])
    assert q[0] >= 60


def test_non_overlapping_candidates_dont_compete():
    """Different read intervals partition separately: both stay 254
    (PartitionOverlappingAlignments, Blasr.cpp:2726)."""
    q = _mq([-900, -880], [0, 260], [250, 500], [0, 2])
    assert q[0] == 254 and q[1] == 254
