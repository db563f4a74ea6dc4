"""Host SDP/global gap filler (ops/sdp.py) — the SDPAlign role."""

import numpy as np

from blasr_jax.ops.banded_align import AlignScores
from blasr_jax.ops.sdp import OP_D, OP_I, OP_M, global_align_dense, sdp_align

S = AlignScores()


def _consumes(ops, qn, tn):
    q = int(np.count_nonzero(ops != OP_D))
    t = int(np.count_nonzero(ops != OP_I))
    return q == qn and t == tn


def _rng_seq(rng, n):
    return rng.integers(0, 4, n).astype(np.uint8)


def test_global_identity():
    rng = np.random.default_rng(0)
    q = _rng_seq(rng, 200)
    ops, score = global_align_dense(q, q, S)
    assert _consumes(ops, 200, 200)
    assert np.all(ops == OP_M)
    assert score == 200 * S.match


def test_global_single_indel():
    rng = np.random.default_rng(1)
    t = _rng_seq(rng, 150)
    q = np.delete(t, 60)  # one deletion in the read
    ops, score = global_align_dense(q, t, S)
    assert _consumes(ops, len(q), len(t))
    assert int(np.count_nonzero(ops == OP_D)) == 1
    assert score == 149 * S.match + S.deletion


def test_global_empty_sides():
    q = np.zeros(0, np.uint8)
    t = np.asarray([0, 1, 2], np.uint8)
    ops, score = global_align_dense(q, t, S)
    assert list(ops) == [OP_D, OP_D, OP_D]
    assert score == 3 * S.deletion


def test_native_matches_numpy_fallback():
    import os

    from blasr_jax import native

    if not native.available():
        return
    rng = np.random.default_rng(2)
    t = _rng_seq(rng, 120)
    q = t.copy()
    q[30] = (q[30] + 1) % 4
    q = np.insert(q, 70, 2)
    nat = native.global_align(q, t, S.match, S.mismatch, S.n_score,
                              S.insertion, S.deletion)
    os.environ["BLASR_JAX_NO_NATIVE"] = "1"
    try:
        # bypass the cached lib by calling the numpy path directly: force
        # max_cells high and monkeypatch native.global_align
        import blasr_jax.ops.sdp as sdp_mod

        orig = native.global_align
        native.global_align = lambda *a, **k: None
        try:
            ops_np, score_np = sdp_mod.global_align_dense(q, t, S)
        finally:
            native.global_align = orig
    finally:
        os.environ.pop("BLASR_JAX_NO_NATIVE", None)
    ops_nat, score_nat = nat
    assert score_nat == score_np
    assert _consumes(ops_nat, len(q), len(t))
    assert _consumes(ops_np, len(q), len(t))


def test_sdp_align_large_recurses_and_covers():
    rng = np.random.default_rng(3)
    t = _rng_seq(rng, 30_000)
    # query = mutated copy (forces the sparse path: 30k x 30k >> dense cap)
    q = t.copy()
    mut = rng.random(len(q)) < 0.05
    q[mut] = (q[mut] + rng.integers(1, 4, mut.sum())) % 4
    ops, score = sdp_align(q, t, S, no_recurse_under=10_000)
    assert _consumes(ops, len(q), len(t))
    # overwhelmingly matches
    assert int(np.count_nonzero(ops == OP_M)) > 0.95 * len(t)
    assert score < 0.8 * len(t) * S.match * 0.9  # strongly negative


def test_sdp_align_with_structural_gap():
    rng = np.random.default_rng(4)
    t = _rng_seq(rng, 20_000)
    # read misses a 3 kb block of the target (deletion SV)
    q = np.concatenate([t[:8_000], t[11_000:]])
    ops, score = sdp_align(q, t, S, no_recurse_under=10_000)
    assert _consumes(ops, len(q), len(t))
    assert int(np.count_nonzero(ops == OP_D)) >= 3_000


def test_sdp_align_tandem_repeat_in_large_gap():
    """Pathological seed set: a tandem-repeat array (60 copies of a 150 bp
    unit) sits inside a ~100 kb gap, and the query carries a different copy
    number (57) — every repeat word is massively multi-mapping, the worst
    case for the LIS chain (reference fragment sweep territory,
    SparseDynamicProgramming.h:71-322). The chain must still pick a
    colinear subset, cover both sequences completely, and absorb the
    3-unit copy-number deletion without shredding the flanks."""
    rng = np.random.default_rng(29)
    unit = _rng_seq(rng, 150)
    left = _rng_seq(rng, 45_000)
    right = _rng_seq(rng, 45_000)
    t = np.concatenate([left, np.tile(unit, 60), right])
    q = np.concatenate([left, np.tile(unit, 57), right])
    ops, score = sdp_align(q, t, S, no_recurse_under=10_000)
    assert _consumes(ops, len(q), len(t))
    n_m = int(np.count_nonzero(ops == OP_M))
    n_d = int(np.count_nonzero(ops == OP_D))
    n_i = int(np.count_nonzero(ops == OP_I))
    # everything in q aligns (flanks are unique and identical); the
    # copy-number difference shows up as ~3 units of deletion, and no
    # spurious insertions are invented
    assert n_m >= len(q) - 150, (n_m, len(q))
    assert abs(n_d - 3 * 150) <= 150, n_d
    assert n_i <= 150, n_i
    # score near the ideal: all-match minus one contiguous 450-base gap
    ideal = len(q) * S.match + 450 * S.deletion
    assert score <= ideal * 0.9, (score, ideal)


def test_sdp_align_tandem_only_window():
    """Query and target are pure tandem array (no unique flank): chain
    ambiguity is total. Alignment must still be complete and mostly
    matches (any colinear register is acceptable)."""
    rng = np.random.default_rng(31)
    unit = _rng_seq(rng, 200)
    t = np.tile(unit, 80)      # 16 kb
    q = np.tile(unit, 76)
    ops, score = sdp_align(q, t, S, no_recurse_under=10_000)
    assert _consumes(ops, len(q), len(t))
    n_m = int(np.count_nonzero(ops == OP_M))
    assert n_m >= 0.95 * len(q), (n_m, len(q))


def test_graph_paper_filter_keeps_colinear_drops_noise():
    """GraphPaper role: colinear seed band survives the grid DP, scattered
    off-path seeds drop."""
    import numpy as np

    from blasr_jax.ops.sdp import graph_paper_filter

    rng = np.random.default_rng(23)
    # colinear chain: t = q + 1000 +- jitter
    qs = np.arange(0, 10_000, 97)
    ts = qs + 1000 + rng.integers(-30, 30, len(qs))
    # noise: random scatter
    nq = rng.integers(0, 10_000, 60)
    nt = rng.integers(0, 12_000, 60)
    q_all = np.concatenate([qs, nq])
    t_all = np.concatenate([ts, nt])
    lens = np.full(len(q_all), 12)
    keep = graph_paper_filter(q_all, t_all, lens, n_rows=24, n_cols=24)
    n_chain = len(qs)
    assert keep[:n_chain].mean() > 0.7          # chain survives
    assert keep[n_chain:].mean() < 0.2          # noise drops
