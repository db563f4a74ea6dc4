import numpy as np
import jax.numpy as jnp
import pytest

from blasr_jax.ops.banded_align import AlignScores, banded_align, make_qoff
from blasr_jax.pipeline.traceback import OP_D, OP_I, OP_M, walk_traceback

SC = AlignScores()
BIG = 10**9


def oracle_local_affine(q, t, sc: AlignScores):
    """Unbanded local min-score affine DP with identical semantics."""
    L, T = len(q), len(t)
    H = np.zeros((L + 1, T + 1), np.int64)
    E = np.full((L + 1, T + 1), BIG, np.int64)
    F = np.full((L + 1, T + 1), BIG, np.int64)
    best = 0
    for i in range(1, L + 1):
        for j in range(1, T + 1):
            E[i][j] = min(E[i][j - 1], H[i][j - 1] + sc.affine_open) + sc.affine_extend
            F[i][j] = min(F[i - 1][j], H[i - 1][j] + sc.affine_open) + sc.affine_extend
            qc, tc = q[i - 1], t[j - 1]
            if qc == tc and qc < 4:
                sub = sc.match
            elif qc >= 4 or tc >= 4:
                sub = sc.n_score
            else:
                sub = sc.mismatch
            h = min(
                H[i - 1][j - 1] + sub,
                H[i - 1][j] + sc.insertion,
                H[i][j - 1] + sc.deletion,
                E[i][j],
                F[i][j],
                0,
            )
            H[i][j] = h
            best = min(best, h)
    return best


def gap_cost(r, lin, sc: AlignScores):
    return min(r * lin, sc.affine_open + r * sc.affine_extend)


def replay_score(path, q, t, sc: AlignScores):
    """Recompute path score: subs + optimal per-run gap decomposition."""
    score = 0
    qp, tp = path.q_start, path.t_start
    i = 0
    ops = path.ops
    n = len(ops)
    while i < n:
        op = ops[i]
        j = i
        while j < n and ops[j] == op:
            j += 1
        run = j - i
        if op == OP_M:
            for _ in range(run):
                qc, tc = q[qp], t[tp]
                if qc == tc and qc < 4:
                    score += sc.match
                elif qc >= 4 or tc >= 4:
                    score += sc.n_score
                else:
                    score += sc.mismatch
                qp += 1
                tp += 1
        elif op == OP_I:
            score += gap_cost(run, sc.insertion, sc)
            qp += run
        else:
            score += gap_cost(run, sc.deletion, sc)
            tp += run
        i = j
    assert qp == path.q_end and tp == path.t_end
    return score


def run_kernel(qs, ts, with_traceback=True):
    I = len(qs)
    L = max(len(x) for x in qs)
    T = max(len(x) for x in ts)
    Q = np.full((I, L), 4, np.uint8)
    Tc = np.full((I, T), 5, np.uint8)
    qlen = np.zeros(I, np.int32)
    thi = np.zeros(I, np.int32)
    for i, (a, b) in enumerate(zip(qs, ts)):
        Q[i, : len(a)] = a
        Tc[i, : len(b)] = b
        qlen[i] = len(a)
        thi[i] = len(b)
    diag = (T - L) // 2
    qoff = make_qoff(L, T, 128, diag)
    res = banded_align(
        jnp.asarray(Q), jnp.asarray(qlen), jnp.asarray(Tc),
        jnp.zeros(I, jnp.int32), jnp.asarray(thi), jnp.asarray(qoff),
        scores=SC, with_traceback=with_traceback,
    )
    return Q, Tc, qoff, res


def test_banded_matches_oracle_small_random(rng):
    # L,T small enough that the 128-band covers the full matrix -> exact
    qs, ts = [], []
    for i in range(16):
        L = int(rng.integers(10, 60))
        T = int(rng.integers(10, 70))
        qs.append(rng.integers(0, 4, L).astype(np.uint8))
        ts.append(rng.integers(0, 4, T).astype(np.uint8))
    # plant some real homology in half the pairs
    for i in range(0, 16, 2):
        n = min(len(qs[i]), len(ts[i]), 30)
        ts[i][:n] = qs[i][:n]
    Q, Tc, qoff, res = run_kernel(qs, ts)
    scores = np.asarray(res.score)
    for i in range(16):
        want = oracle_local_affine(qs[i], ts[i], SC)
        assert scores[i] == want, f"item {i}: kernel {scores[i]} oracle {want}"


def test_traceback_consistent(rng):
    qs, ts = [], []
    for i in range(8):
        L = int(rng.integers(30, 80))
        base = rng.integers(0, 4, 120).astype(np.uint8)
        # query = noisy copy of a slice of target
        q = []
        for c in base[20 : 20 + L]:
            r = rng.random()
            if r < 0.08:
                q.append(int(rng.integers(0, 4)))  # sub / ins
                if rng.random() < 0.5:
                    q.append(int(c))
            elif r < 0.14:
                continue  # deletion
            else:
                q.append(int(c))
        qs.append(np.asarray(q, np.uint8))
        ts.append(base)
    Q, Tc, qoff, res = run_kernel(qs, ts)
    scores = np.asarray(res.score)
    paths = walk_traceback(
        np.asarray(res.arrows), np.asarray(qoff),
        np.asarray(res.best_a), np.asarray(res.best_w), scores, Q, Tc,
    )
    for i, p in enumerate(paths):
        assert p is not None
        assert 0 <= p.q_start <= p.q_end <= len(qs[i])
        assert 0 <= p.t_start <= p.t_end <= len(ts[i])
        got = replay_score(p, Q[i], Tc[i], SC)
        assert got == scores[i], f"item {i}: replay {got} vs kernel {scores[i]}"
        # most of the query should be aligned
        assert p.q_end - p.q_start >= 0.8 * len(qs[i])
        # stats add up
        assert p.n_match + p.n_mismatch == int(np.count_nonzero(p.ops == OP_M))
        assert p.n_ins == int(np.count_nonzero(p.ops == OP_I))
        assert p.n_del == int(np.count_nonzero(p.ops == OP_D))


def test_perfect_match_score():
    q = np.array([0, 1, 2, 3] * 10, np.uint8)
    t = np.concatenate([np.full(7, 2, np.uint8), q, np.full(9, 1, np.uint8)])
    Q, Tc, qoff, res = run_kernel([q], [t])
    assert int(res.score[0]) == SC.match * 40
    paths = walk_traceback(
        np.asarray(res.arrows), np.asarray(qoff),
        np.asarray(res.best_a), np.asarray(res.best_w), np.asarray(res.score), Q, Tc,
    )
    p = paths[0]
    assert (p.q_start, p.q_end) == (0, 40)
    assert (p.t_start, p.t_end) == (7, 47)
    assert p.n_match == 40 and p.n_mismatch == 0 and p.n_ins == 0 and p.n_del == 0


def test_no_alignment_when_dissimilar(rng):
    q = np.zeros(30, np.uint8)          # AAAA...
    t = np.full(40, 1, np.uint8)        # CCCC...
    Q, Tc, qoff, res = run_kernel([q], [t])
    assert int(res.score[0]) == 0
    paths = walk_traceback(
        np.asarray(res.arrows), np.asarray(qoff),
        np.asarray(res.best_a), np.asarray(res.best_w), np.asarray(res.score), Q, Tc,
    )
    assert paths[0] is None


def test_device_walk_matches_host_walk(rng):
    """On-device traceback must reproduce the host replay exactly."""
    import jax.numpy as jnp

    from blasr_jax.ops.traceback_device import (
        pack_codes_rows,
        packed_width,
        unpack_moves,
        walk_arrows_device,
    )

    qs, ts = [], []
    for i in range(8):
        L = int(rng.integers(30, 90))
        base = rng.integers(0, 4, 140).astype(np.uint8)
        q = []
        for c in base[25 : 25 + L]:
            r = rng.random()
            if r < 0.1:
                q.append(int(rng.integers(0, 4)))
                if rng.random() < 0.5:
                    q.append(int(c))
            elif r < 0.16:
                continue
            else:
                q.append(int(c))
        qs.append(np.asarray(q, np.uint8))
        ts.append(base)
    # one hopeless pair -> no alignment path
    qs.append(np.zeros(40, np.uint8))
    ts.append(np.full(140, 1, np.uint8))
    Q, Tc, qoff, res = run_kernel(qs, ts)
    scores = np.asarray(res.score)
    host_paths = walk_traceback(
        np.asarray(res.arrows), np.asarray(qoff),
        np.asarray(res.best_a), np.asarray(res.best_w), scores, Q, Tc,
    )
    tb = walk_arrows_device(
        res.arrows, jnp.asarray(qoff), res.best_a, res.best_w, res.score,
        jnp.asarray(Q), jnp.asarray(Tc),
    )
    S = int(res.arrows.shape[0])
    packed = np.asarray(pack_codes_rows(tb.moves_codes, tb.nops, packed_width(S)))
    nops = np.asarray(tb.nops)
    for i, hp in enumerate(host_paths):
        if hp is None:
            assert scores[i] >= 0 or nops[i] == 0
            continue
        ops = unpack_moves(packed[i], int(nops[i]))
        np.testing.assert_array_equal(ops, hp.ops)
        assert int(tb.q_start[i]) == hp.q_start
        assert int(tb.q_end[i]) == hp.q_end
        assert int(tb.t_start[i]) == hp.t_start
        assert int(tb.t_end[i]) == hp.t_end
        assert int(tb.n_match[i]) == hp.n_match
        assert int(tb.n_mismatch[i]) == hp.n_mismatch
        assert int(tb.n_ins[i]) == hp.n_ins
        assert int(tb.n_del[i]) == hp.n_del


def test_score_matrix_substitution():
    """-scoreMatrix role (StringToScoreMatrix.h): a matrix with free A<->C
    substitutions scores an A->C-mutated read like an exact match."""
    import numpy as np
    import jax.numpy as jnp

    from blasr_jax.ops.banded_align import AlignScores, banded_align, make_qoff

    rng = np.random.default_rng(3)
    L, T = 200, 260
    q = rng.integers(0, 4, (4, L)).astype(np.uint8)
    t = rng.integers(0, 4, (4, T)).astype(np.uint8)
    t[:, 20 : 20 + L] = q
    # mutate A->C in the read only
    qm = q.copy()
    qm[q == 0] = 1

    mat = [0] * 25
    for i in range(5):
        for j in range(5):
            if i == j and i < 4:
                mat[i * 5 + j] = -5
            elif i >= 4 or j >= 4:
                mat[i * 5 + j] = 0
            else:
                mat[i * 5 + j] = 6
    mat[0 * 5 + 1] = -5  # q=A read as C matches target A... (q x t: C vs A)
    mat[1 * 5 + 0] = -5  # q=C vs t=A free
    mat[0 * 5 + 1] = -5  # q=A vs t=C free
    scores = AlignScores(matrix=tuple(mat))

    args = (
        jnp.asarray(qm), jnp.full(4, L, jnp.int32), jnp.asarray(t),
        jnp.zeros(4, jnp.int32), jnp.full(4, T, jnp.int32),
        jnp.asarray(make_qoff(L, T, 128, (T - L) // 2)),
    )
    ref = banded_align(*args, None, scores=scores, with_traceback=True)
    # every position scores -5 (match or free A/C sub): perfect-score result
    assert np.all(np.asarray(ref.score) == -5 * L)


def test_walk_stats_with_negative_offdiagonal_matrix():
    """-scoreMatrix with a negative off-diagonal lets local alignments START
    on a mismatch; the arrow word's DIAG_START mismatch bit must keep
    n_match/n_mismatch exact (review fix)."""
    import numpy as np

    from blasr_jax.ops.traceback_device import walk_arrows_device

    # A<->C substitution scores -2 (negative off-diagonal)
    mat = [
        -5, -2, 6, 6, 0,
        -2, -5, 6, 6, 0,
        6, 6, -5, 6, 0,
        6, 6, 6, -5, 0,
        0, 0, 0, 0, 0,
    ]
    sc = AlignScores(matrix=tuple(mat))
    rng = np.random.default_rng(31)
    I, L, T = 8, 120, 180
    Q = rng.integers(0, 4, (I, L)).astype(np.uint8)
    Tc = rng.integers(0, 4, (I, T)).astype(np.uint8)
    for i in range(I):
        c = Q[i, :100].copy()
        mut = rng.random(100) < 0.15
        c[mut] = (c[mut] + rng.integers(1, 4, 100)[mut]) % 4
        Tc[i, 30:130] = c
    qoff = jnp.asarray(make_qoff(L, T, 128, (T - L) // 2))
    res = banded_align(
        jnp.asarray(Q), jnp.full(I, L, jnp.int32), jnp.asarray(Tc),
        jnp.zeros(I, jnp.int32), jnp.full(I, T, jnp.int32), qoff,
        scores=sc, with_traceback=True,
    )
    tb = walk_arrows_device(
        res.arrows, qoff, res.best_a, res.best_w,
        jnp.minimum(res.score, -1), jnp.asarray(Q), jnp.asarray(Tc),
    )
    from blasr_jax.ops.traceback_device import pack_codes_rows, packed_width
    from blasr_jax.ops.traceback_device import unpack_moves

    S = L + T - 1
    packed = np.asarray(pack_codes_rows(tb.moves_codes, tb.nops, packed_width(S)))
    for i in range(I):
        qs, qe = int(tb.q_start[i]), int(tb.q_end[i])
        ts, te = int(tb.t_start[i]), int(tb.t_end[i])
        nm = int(tb.n_match[i])
        nmm = int(tb.n_mismatch[i])
        ni, nd = int(tb.n_ins[i]), int(tb.n_del[i])
        # op-count identities
        assert (qe - qs) == (nm + nmm + ni)
        assert (te - ts) == (nm + nmm + nd)
        assert int(tb.nops[i]) == nm + nmm + ni + nd
        # replay the move string against the sequences: the device tallies
        # must equal ground truth even when alignments start on a mismatch
        ops = unpack_moves(packed[i], int(tb.nops[i]))
        qp, tp = qs, ts
        true_nm = 0
        for op in ops:
            if op == 1:
                true_nm += int(Q[i, qp] == Tc[i, tp])
                qp += 1
                tp += 1
            elif op == 2:
                qp += 1
            else:
                tp += 1
        assert (qp, tp) == (qe, te)
        assert true_nm == nm, (i, true_nm, nm)


def test_mismatch_start_run_not_double_counted():
    """Deterministic repro from review: an alignment that STARTS on a
    mismatch (negative off-diagonal matrix) then extends diagonally must
    tally the start mismatch exactly once."""
    import numpy as np

    from blasr_jax.ops.traceback_device import walk_arrows_device

    mat = [
        -5, -2, 6, 6, 0,
        -2, -5, 6, 6, 0,
        6, 6, -5, 6, 0,
        6, 6, 6, -5, 0,
        0, 0, 0, 0, 0,
    ]
    sc = AlignScores(matrix=tuple(mat))
    # query C + 20xG vs target A + 20xG: optimal local alignment starts on
    # the C/A mismatch (-2) and runs 20 matching Gs
    q = np.array([1] + [2] * 20, np.uint8)
    t = np.array([0] + [2] * 20, np.uint8)
    I, L, T = 1, len(q), len(t) + 8
    Q = q[None, :]
    Tc = np.full((I, T), 3, np.uint8)
    Tc[0, : len(t)] = t
    qoff = jnp.asarray(make_qoff(L, T, 128, (T - L) // 2))
    res = banded_align(
        jnp.asarray(Q), jnp.asarray([L], jnp.int32), jnp.asarray(Tc),
        jnp.zeros(I, jnp.int32), jnp.full(I, T, jnp.int32), qoff,
        scores=sc, with_traceback=True,
    )
    tb = walk_arrows_device(
        res.arrows, qoff, res.best_a, res.best_w,
        jnp.minimum(res.score, -1), jnp.asarray(Q), jnp.asarray(Tc),
    )
    assert int(res.score[0]) == -2 + 20 * -5
    assert int(tb.n_match[0]) == 20, int(tb.n_match[0])
    assert int(tb.n_mismatch[0]) == 1, int(tb.n_mismatch[0])


def test_fuzz_kernel_configs_vs_bruteforce():
    """Randomized differential test: the best score == brute-force
    unbanded local DP whenever the band covers the full rectangle."""
    import numpy as np

    from blasr_jax.oracle import local_affine_score

    rng = np.random.default_rng(77)
    for trial in range(12):
        L = int(rng.integers(20, 60))
        T = int(rng.integers(L, L + 40))
        W = int(rng.choice([32, 64, 128]))
        I = int(rng.integers(2, 6))
        Q = rng.integers(0, 5, (I, L)).astype(np.uint8)   # incl. N
        Tc = rng.integers(0, 5, (I, T)).astype(np.uint8)
        for i in range(I):
            n = min(L - 4, T)
            Tc[i, :n] = np.where(
                rng.random(n) < 0.8, Q[i, :n], Tc[i, :n]
            )
        qlen = rng.integers(10, L + 1, I).astype(np.int32)
        sc = AlignScores()
        qoff = jnp.asarray(make_qoff(L, T, W, (T - L) // 2))
        args = (
            jnp.asarray(Q), jnp.asarray(qlen), jnp.asarray(Tc),
            jnp.zeros(I, jnp.int32), jnp.full(I, T, jnp.int32), qoff,
        )
        ref = banded_align(*args, None, scores=sc, with_traceback=True,
                           band_width=W)
        if W >= L and W >= T:
            # full-rectangle band: banded == unbanded brute force
            for i in range(I):
                bf = local_affine_score(Q[i, : qlen[i]], Tc[i], sc)
                assert int(ref.score[i]) == bf, (trial, i)


def test_global_in_query_score_vs_bruteforce():
    """banded_align(global_q=True) must equal the exhaustive global-in-query
    / free-in-target DP (the reference's 'hybrid of global/local' refinement
    score that the -maxScore print gate tests): every query base consumed,
    target start+end free, affine gaps."""
    import numpy as np
    import jax.numpy as jnp

    from blasr_jax.ops.banded_align import AlignScores, banded_align, make_qoff

    rng = np.random.default_rng(5)
    sc = AlignScores(match=-5, mismatch=6, insertion=5, deletion=5,
                     affine_open=10, affine_extend=2)
    INFh = 10 ** 9

    def brute(q, t):
        Lq, Lt = len(q), len(t)
        # H[i][j]: best score consuming q[:i], last op ended at t[:j];
        # E/F affine states. Global in i (must reach i = Lq), free in j.
        H = np.full((Lq + 1, Lt + 1), INFh, np.int64)
        E = np.full((Lq + 1, Lt + 1), INFh, np.int64)
        F = np.full((Lq + 1, Lt + 1), INFh, np.int64)
        H[0, :] = 0  # free target start
        for i in range(1, Lq + 1):
            for j in range(0, Lt + 1):
                F[i, j] = min(F[i - 1, j] + sc.affine_extend,
                              H[i - 1, j] + sc.affine_open + sc.affine_extend)
                best = H[i - 1, j] + sc.insertion  # linear insertion
                if F[i, j] < best:
                    best = F[i, j]
                if j > 0:
                    E[i, j] = min(E[i, j - 1] + sc.affine_extend,
                                  H[i, j - 1] + sc.affine_open + sc.affine_extend)
                    sub = sc.match if q[i - 1] == t[j - 1] else sc.mismatch
                    best = min(best, H[i - 1, j - 1] + sub,
                               H[i, j - 1] + sc.deletion, E[i, j])
                H[i, j] = best
        return int(H[Lq].min())

    for trial in range(12):
        L = int(rng.integers(8, 28))
        T = L + 16
        q = rng.integers(0, 4, (1, L)).astype(np.uint8)
        t = rng.integers(0, 4, (1, T)).astype(np.uint8)
        if trial % 3 == 0:
            # plant a partial copy so some real alignment exists
            t[0, 4 : 4 + L // 2] = q[0, : L // 2]
        W = 128
        qoff = jnp.asarray(make_qoff(L, T, W, T // 2 - L // 2))
        res = banded_align(
            jnp.asarray(q), jnp.asarray([L], jnp.int32), jnp.asarray(t),
            jnp.asarray([0], jnp.int32), jnp.asarray([T], jnp.int32),
            qoff, scores=sc, band_width=W, global_q=True,
        )
        want = brute(q[0], t[0])
        assert int(res.score[0]) == want, (trial, int(res.score[0]), want)


OFFDIAG_MATRIX = (
    -5, -2, 6, 6, 0,
    -2, -5, 6, 6, 0,
    6, 6, -5, 6, 0,
    6, 6, 6, -5, 0,
    0, 0, 0, 0, 0,
)


def _drifting_problem(rng, I, L, T):
    """Noisy copies of target segments with an indel burst, so the path
    drifts across a band narrower than the query."""
    Q = np.full((I, L), 4, np.uint8)
    Tc = rng.integers(0, 4, (I, T)).astype(np.uint8)
    qlen = np.zeros(I, np.int32)
    for i in range(I):
        seg = Tc[i, 24 : 24 + L - 8].copy()
        cut = len(seg) // 2
        if i % 2:
            seg = np.concatenate([seg[:cut], seg[cut + 10 :]])       # deletion
        else:
            seg = np.concatenate(
                [seg[:cut], rng.integers(0, 4, 10).astype(np.uint8), seg[cut:]]
            )[: L - 2]                                               # insertion
        mut = rng.random(len(seg)) < 0.06
        seg[mut] = (seg[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        Q[i, : len(seg)] = seg
        qlen[i] = len(seg)
    return Q, Tc, qlen


def _schedule(mode, L, T, W, I):
    from blasr_jax.ops.banded_align import (
        QOFF_SHIFT, clamp_knots_to_shared, make_qoff_knots, make_qoff_num,
        qoff_from_knots,
    )

    S = L + T - 1
    diag = (T - L) // 2
    shared = jnp.asarray(make_qoff(L, T, W, diag))
    if mode == "sloped":
        return make_qoff_num(L, T, W, diag, round((1 << QOFF_SHIFT) / 1.92))
    if mode != "knots":
        return shared
    # per-item guides through three anchors along each item's own drift
    aq = np.tile(np.array([[8, L // 2 - 8, L - 24]], np.int32), (I, 1))
    drift = np.array([[0, 0, (-1) ** i * 10] for i in range(I)], np.int32)
    at = aq + 24 + drift
    knots = make_qoff_knots(
        jnp.asarray(aq + at), jnp.asarray(aq - W // 2),
        jnp.ones((I, 3), bool), S, L, W, diag=diag,
        num=1 << (QOFF_SHIFT - 1),
    )
    return qoff_from_knots(clamp_knots_to_shared(knots, shared, W), S)


@pytest.mark.parametrize("W", [32, 64, 128, 256])
@pytest.mark.parametrize(
    "mode", ["shared", "sloped", "knots", "qual8", "qual16", "matrix"]
)
def test_banded_align_vs_banded_bruteforce(mode, W):
    """banded_align == the cell-by-cell banded oracle (score and end cell)
    for every schedule, quality stream and scoring mode the mapper uses,
    with a band narrower than the query so the schedule matters."""
    from blasr_jax.oracle import banded_local_affine

    rng = np.random.default_rng(W + len(mode))
    I, L = 3, W + 48
    T = L + 64
    Q, Tc, qlen = _drifting_problem(rng, I, L, T)
    qoff = _schedule(mode, L, T, W, I)
    qual = None
    if mode == "qual8":
        qual = rng.integers(3, 45, (I, L)).astype(np.uint8)
    elif mode == "qual16":
        qual = rng.integers(3, 45, (I, L)).astype(np.uint16) | (
            rng.integers(3, 45, (I, L)).astype(np.uint16) << 8
        )
    sc = AlignScores(matrix=OFFDIAG_MATRIX if mode == "matrix" else None)
    tlo = np.array([0, 5, 0], np.int32)
    thi = np.array([T, T, T - 7], np.int32)
    res = banded_align(
        jnp.asarray(Q), jnp.asarray(qlen), jnp.asarray(Tc),
        jnp.asarray(tlo), jnp.asarray(thi), qoff,
        None if qual is None else jnp.asarray(qual),
        scores=sc, with_traceback=True, band_width=W,
    )
    qo = np.asarray(qoff)
    for i in range(I):
        want = banded_local_affine(
            Q[i, : qlen[i]], Tc[i], sc, qo if qo.ndim == 1 else qo[:, i], W,
            None if qual is None else qual[i, : qlen[i]],
            tlo=int(tlo[i]), thi=int(thi[i]),
        )
        got = (int(res.score[i]), int(res.best_a[i]), int(res.best_w[i]))
        assert got == want, (i, got, want)
        assert want[0] < -100, "the problem must hold a real alignment"


def test_device_walk_narrow_sloped_band():
    """The device walk over (S, I, W) arrows at W = 32 under a drift-slope
    schedule: the table-driven walk, the walk that evaluates the schedule
    analytically (the mapper's form) and the host replay agree."""
    from blasr_jax.ops.banded_align import QOFF_SHIFT, make_qoff_num
    from blasr_jax.ops.traceback_device import (
        pack_codes_rows, packed_width, unpack_moves, walk_arrows_device,
    )

    rng = np.random.default_rng(32)
    I, W, L = 6, 32, 160
    T = L + 64
    Q, Tc, qlen = _drifting_problem(rng, I, L, T)
    diag = (T - L) // 2
    num = jnp.int32(round((1 << QOFF_SHIFT) / 1.96))
    qoff = make_qoff_num(L, T, W, diag, num)
    res = banded_align(
        jnp.asarray(Q), jnp.asarray(qlen), jnp.asarray(Tc),
        jnp.zeros(I, jnp.int32), jnp.full(I, T, jnp.int32), qoff,
        with_traceback=True, band_width=W,
    )
    args = (res.arrows, qoff, res.best_a, res.best_w, res.score,
            jnp.asarray(Q), jnp.asarray(Tc))
    table = walk_arrows_device(*args)
    analytic = walk_arrows_device(*args, qoff_params=(diag, W, L), qoff_num=num)
    for f in table._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(table, f)), np.asarray(getattr(analytic, f)),
            err_msg=f,
        )
    host = walk_traceback(
        np.asarray(res.arrows), np.asarray(qoff), np.asarray(res.best_a),
        np.asarray(res.best_w), np.asarray(res.score), Q, Tc,
    )
    packed = np.asarray(
        pack_codes_rows(table.moves_codes, table.nops, packed_width(L + T - 1))
    )
    for i, hp in enumerate(host):
        assert hp is not None
        np.testing.assert_array_equal(
            unpack_moves(packed[i], int(table.nops[i])), hp.ops
        )
        assert (int(table.q_start[i]), int(table.t_start[i])) == (
            hp.q_start, hp.t_start
        )
        assert replay_score(hp, Q[i], Tc[i], SC) == int(res.score[i])
