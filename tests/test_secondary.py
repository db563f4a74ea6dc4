"""Reference-faithful secondary admission machinery (-bestn tail):
SDPAlign reimplementation, affine stats-score semantics, and the
maximal-match anchor list behind the SumAnchors interval gate.

The heavyweight ground truth is scripts/sdp_diff.py (differential vs the
reference's own SDPAlign compiled from /root/reference, 27/28 exact with
one ±20 SW-traceback-tie divergence); these tests pin the properties the
pipeline depends on without needing the reference binary.
"""

import numpy as np
import pytest

from blasr_jax.pipeline.secondary_refine import (
    _blocks_stats_score,
    blocks_to_ops,
    reference_anchor_list,
    sdp_interval_align,
    stats_from_blocks,
    sum_anchors_window,
)


@pytest.fixture
def rng():
    return np.random.default_rng(5)


def test_sdp_perfect_copy_exact_score(rng):
    tpl = rng.integers(0, 4, 500).astype(np.uint8)
    t = np.concatenate(
        [rng.integers(0, 4, 80).astype(np.uint8), tpl,
         rng.integers(0, 4, 80).astype(np.uint8)]
    )
    sc, blocks = sdp_interval_align(tpl, t)
    assert sc == -5 * 500
    assert blocks[0][0] == 0 and blocks[-1][0] + blocks[-1][2] == 500


def test_sdp_junk_window_scores_positive(rng):
    """A window with no real homology must score ABOVE -maxScore=-200 (the
    admission cut): scattered word matches chain into something the gap
    render prices out — the mechanism that keeps junk secondaries out."""
    q = rng.integers(0, 4, 700).astype(np.uint8)
    t = rng.integers(0, 4, 900).astype(np.uint8)
    sc, blocks = sdp_interval_align(q, t)
    assert not blocks or sc > -200


def test_sdp_partial_chain_short_span(rng):
    """Only q200-500 matches the window: the Local chain must span just
    the supported region (the reference's short-span secondaries)."""
    t = rng.integers(0, 4, 1000).astype(np.uint8)
    q = rng.integers(0, 4, 800).astype(np.uint8)
    q[200:500] = t[300:600]
    sc, blocks = sdp_interval_align(q, t, prefix_len=0)
    assert sc <= -5 * 280
    assert abs(blocks[0][0] - 200) <= 12
    assert abs((blocks[-1][0] + blocks[-1][2]) - 500) <= 12


def test_affine_stats_gap_run_cost():
    """A (0, 300) gap pair costs min(300*dele, affineOpen)=50 with the
    reference's affineAlign default; 1500 without (AlignmentUtils.h:61-124
    string scorer semantics)."""
    q = np.zeros(20, np.uint8)          # AAAA...
    t = np.zeros(320, np.uint8)
    blocks = [[0, 0, 10], [10, 310, 10]]
    aff = _blocks_stats_score(
        blocks, q, t, match=-5, mismatch=6, n_score=0, ins=5, dele=5,
        affine=True, affine_open=50, affine_extend=0,
    )
    lin = _blocks_stats_score(
        blocks, q, t, match=-5, mismatch=6, n_score=0, ins=5, dele=5,
        affine=False,
    )
    assert aff == -100 + 50
    assert lin == -100 + 1500


def test_blocks_to_ops_matches_stats_counts(rng):
    t = rng.integers(0, 4, 600).astype(np.uint8)
    q = t[50:550].copy()
    mut = rng.random(500) < 0.1
    q[mut] = (q[mut] + 1) % 4
    _, blocks = sdp_interval_align(q, t)
    nm, nx, ni, nd = stats_from_blocks(blocks, q, t)
    ops = blocks_to_ops(blocks)
    assert (ops == 1).sum() == nm + nx
    assert (ops == 2).sum() == ni
    assert (ops == 3).sum() == nd


def _mini_index(genome):
    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.seqdb import SeqDB

    seqdb = SeqDB(["ref"], np.array([0, len(genome)], np.int64), ["0" * 32])
    return build_index_from_arrays(genome, seqdb, k=14)


def test_reference_anchor_list_dominance_and_deficit(rng):
    """A diverged repeat copy collects anchors ONLY at positions where it
    matches as long as the source locus (maximal-match dominance), and
    the .sa length deficit (-5) drops anchors whose true maximal match is
    below minMatch+5 — the two effects behind the reference's sparse
    repeat windows (SumAnchors <= minInterval rejects them)."""
    src = rng.integers(0, 4, 600).astype(np.uint8)
    copy = src.copy()
    mut = rng.random(600) < 0.06         # ~every 17 bases differs
    copy[mut] = (copy[mut] + 1) % 4
    genome = np.concatenate(
        [rng.integers(0, 4, 200).astype(np.uint8), src,
         rng.integers(0, 4, 200).astype(np.uint8), copy,
         rng.integers(0, 4, 200).astype(np.uint8)]
    )
    idx = _mini_index(genome)
    # a clean read drawn from the source
    read = src.copy()
    aq, at, al = reference_anchor_list(
        read, genome, idx.sa, idx.sa_kmers, idx.k, min_match=14
    )
    src_sum = sum_anchors_window(at, al, 200, 800)
    copy_sum = sum_anchors_window(at, al, 1000, 1600)
    assert src_sum > 3 * max(copy_sum, 1), (src_sum, copy_sum)
    assert src_sum > 100        # real locus passes the minInterval gate
    # deficit: no surviving anchor shorter than min_match, and every
    # anchor's TRUE match is at least min_match + 5
    assert (al >= 14).all()


def test_reference_anchor_list_encompass_removal(rng):
    """Consecutive positions of one exact run collapse to the run start
    (RemoveOverlappingAnchors, FindMaxInterval.h:279-312)."""
    src = rng.integers(0, 4, 400).astype(np.uint8)
    genome = np.concatenate(
        [rng.integers(0, 4, 100).astype(np.uint8), src,
         rng.integers(0, 4, 100).astype(np.uint8)]
    )
    idx = _mini_index(genome)
    read = src[:100].copy()              # exact 100-base read
    aq, at, al = reference_anchor_list(
        read, genome, idx.sa, idx.sa_kmers, idx.k, min_match=14
    )
    m = (at >= 100) & (at < 500)
    # one run -> one anchor at the run start, length = run - deficit
    assert m.sum() == 1
    assert aq[m][0] == 0 and at[m][0] == 100
    assert al[m][0] == 100 - 5
