"""Sparse dynamic programming alignment (host-side; L4).

Role of reference ``SDPAlign`` (common/algorithms/alignment/SDPAlign.h:25,96)
and its sweep core ``SDPLongestCommonSubsequence``
(sdp/SparseDynamicProgramming.h:71-322): align a query against a candidate
target window by (1) k-mer merge-join seeding, (2) sparse colinear chaining,
(3) dense DP fills of the inter-seed gaps, recursing with a smaller word
when a gap is too large for the dense matrix (SDPAlign.h:437-599).

This host module serves the long-query/piecewise path, where gaps between
stitched device-aligned segments must be truly aligned rather than emitted
as unscored indel runs (reference refineBetweenAnchorsOnly,
Blasr.cpp:1578-1634 AlignSubstring per inter-anchor gap <= 100 kb). The
batched per-read alignment path never calls this — the wide-band wavefront
kernel subsumes SDP there; only contig-scale work (rare, host-latency
tolerant) lands here.

The chain step is a vectorized numpy LIS-by-diagonal rather than the
reference's fragment sweep set; seeds are exact-match words so chaining
exactness only affects which gaps get dense-filled, not correctness of the
emitted alignment.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from blasr_jax.ops.banded_align import AlignScores

OP_M, OP_I, OP_D = 1, 2, 3


def global_align_dense(
    q: np.ndarray, t: np.ndarray, scores: AlignScores,
    max_cells: int = 1 << 26,
) -> Optional[tuple[np.ndarray, int]]:
    """Dense global alignment (both ends pinned). Native C++ when available,
    numpy row-sweep fallback. Returns (ops START->END, score) or None when
    the matrix would exceed max_cells."""
    from blasr_jax import native

    qn, tn = len(q), len(t)
    if qn == 0 and tn == 0:
        return np.zeros(0, np.uint8), 0
    if qn == 0:
        return np.full(tn, OP_D, np.uint8), tn * scores.deletion
    if tn == 0:
        return np.full(qn, OP_I, np.uint8), qn * scores.insertion
    if (qn + 1) * (tn + 1) > max_cells:
        return None
    out = native.global_align(
        q, t, scores.match, scores.mismatch, scores.n_score,
        scores.insertion, scores.deletion, max_cells,
    )
    if out is not None:
        return out
    # numpy fallback: full H matrix, row sweep
    H = np.empty((qn + 1, tn + 1), np.int32)
    H[0, :] = np.arange(tn + 1, dtype=np.int32) * scores.deletion
    H[:, 0] = np.arange(qn + 1, dtype=np.int32) * scores.insertion
    t_arr = t.astype(np.int16)
    for i in range(1, qn + 1):
        qc = int(q[i - 1])
        sub = np.where(
            (t_arr == qc) & (qc < 4), scores.match,
            np.where((t_arr >= 4) | (qc >= 4), scores.n_score, scores.mismatch),
        ).astype(np.int32)
        diag = H[i - 1, :-1] + sub
        up = H[i - 1, 1:] + scores.insertion
        row = H[i]
        best = np.minimum(diag, up)
        # left dependency is sequential: resolve with a scan
        acc = row[0]
        for j in range(1, tn + 1):
            acc = min(best[j - 1], acc + scores.deletion)
            row[j] = acc
    score = int(H[qn, tn])
    ops_rev = []
    i, j = qn, tn
    while i > 0 or j > 0:
        if i > 0 and j > 0:
            qc, tc = int(q[i - 1]), int(t[j - 1])
            sub = (
                scores.match if (qc == tc and qc < 4)
                else scores.n_score if (qc >= 4 or tc >= 4)
                else scores.mismatch
            )
            if H[i, j] == H[i - 1, j - 1] + sub:
                ops_rev.append(OP_M)
                i -= 1
                j -= 1
                continue
        if i > 0 and H[i, j] == H[i - 1, j] + scores.insertion:
            ops_rev.append(OP_I)
            i -= 1
            continue
        ops_rev.append(OP_D)
        j -= 1
    return np.asarray(ops_rev[::-1], np.uint8), score


def _pack_words(codes: np.ndarray, word: int) -> np.ndarray:
    """Packed 2-bit words at every position; -1 where the window has N."""
    n = len(codes)
    if n < word:
        return np.full(0, -1, np.int64)
    c = codes.astype(np.int64)
    acc = np.zeros(n - word + 1, np.int64)
    bad = np.zeros(n - word + 1, bool)
    for j in range(word):
        w = c[j : j + n - word + 1]
        acc = (acc << 2) | (w & 3)
        bad |= w >= 4
    return np.where(bad, -1, acc)


def _chain_seeds(qpos: np.ndarray, tpos: np.ndarray, word: int) -> np.ndarray:
    """Greedy colinear chain of exact-match seeds: sort by q, keep a
    monotone (q, t) subsequence via patience LIS on t (np + binary search).
    Returns indices of chained seeds in order."""
    order = np.lexsort((tpos, qpos))
    qs, ts = qpos[order], tpos[order]
    n = len(qs)
    if n == 0:
        return np.zeros(0, np.int64)
    # LIS on ts (strictly increasing keeps seeds colinear & non-overlapping
    # in t; q already sorted)
    tails: list[int] = []          # last t of best chain of each length
    tails_idx: list[int] = []
    parent = np.full(n, -1, np.int64)
    import bisect

    for i in range(n):
        v = int(ts[i])
        k = bisect.bisect_left(tails, v)
        if k == len(tails):
            tails.append(v)
            tails_idx.append(i)
        else:
            tails[k] = v
            tails_idx[k] = i
        parent[i] = tails_idx[k - 1] if k > 0 else -1
    # reconstruct
    out = []
    i = tails_idx[len(tails) - 1]
    while i >= 0:
        out.append(i)
        i = int(parent[i])
    out.reverse()
    return order[np.asarray(out, np.int64)]


def sdp_align(
    q: np.ndarray,
    t: np.ndarray,
    scores: AlignScores = AlignScores(),
    word: int = 11,
    no_recurse_under: int = 10_000,
    max_hits_per_word: int = 8,
    _depth: int = 0,
) -> tuple[np.ndarray, int]:
    """Global alignment of q vs t via sparse seeding + recursive fills.

    Always returns a complete op string covering all of q and t (START->END
    order); regions with no seed support and matrices too large to fill
    densely degrade to unscored I/D runs (the reference leaves such gaps
    unaligned as well — OneGapAlignment territory).
    """
    qn, tn = len(q), len(t)
    dense = global_align_dense(q, t, scores, max_cells=no_recurse_under)
    if dense is not None:
        return dense
    if _depth >= 3 or word < 5 or qn < word or tn < word:
        ops = np.concatenate(
            [np.full(qn, OP_I, np.uint8), np.full(tn, OP_D, np.uint8)]
        )
        return ops, qn * scores.insertion + tn * scores.deletion

    tw = _pack_words(t, word)
    qw = _pack_words(q, word)
    t_order = np.argsort(tw, kind="stable")
    tw_sorted = tw[t_order]
    lo = np.searchsorted(tw_sorted, qw, side="left")
    hi = np.searchsorted(tw_sorted, qw, side="right")
    counts = np.minimum(hi - lo, max_hits_per_word)
    valid_q = (qw >= 0) & (counts > 0)
    reps = counts * valid_q
    qpos = np.repeat(np.arange(len(qw)), reps)
    offs = np.concatenate([np.arange(c) for c in reps]) if reps.sum() else np.zeros(0, np.int64)
    # For multi-mapping words (tandem repeats: one word can hit every copy
    # in the array), keep the hits NEAREST the expected global diagonal
    # t ~ q * tn/qn instead of the lowest t positions — otherwise every
    # query copy seeds only the first max_hits copies of the target array
    # and the chain collapses there (the reference's fragment sweep sees
    # all fragments; we cap, so cap around the right register).
    # tw_sorted is stable-sorted: within one word value, positions ascend —
    # a combined (word, pos) key is therefore globally sorted and
    # searchsorted finds each word's diagonal-ideal rank directly.
    start = lo
    over = (hi - lo) > max_hits_per_word
    if np.any(over):
        keys_sorted = tw_sorted * np.int64(tn + 1) + t_order
        ideal_t = (np.arange(len(qw), dtype=np.int64) * tn) // max(qn, 1)
        ctr = np.searchsorted(keys_sorted, qw * np.int64(tn + 1) + ideal_t)
        centered = np.clip(ctr - max_hits_per_word // 2, lo,
                           np.maximum(hi - max_hits_per_word, lo))
        start = np.where(over, centered, lo)
    tpos = t_order[np.repeat(start, reps) + offs]

    if len(qpos) == 0:
        ops = np.concatenate(
            [np.full(qn, OP_I, np.uint8), np.full(tn, OP_D, np.uint8)]
        )
        return ops, qn * scores.insertion + tn * scores.deletion

    chain = _chain_seeds(qpos, tpos, word)
    cq, ct = qpos[chain], tpos[chain]
    # drop seeds overlapping the previous seed in q or t (keep colinear,
    # non-overlapping blocks like SDPAlign's block condensation)
    keep = [0]
    for i in range(1, len(cq)):
        if cq[i] >= cq[keep[-1]] + word and ct[i] >= ct[keep[-1]] + word:
            keep.append(i)
    cq, ct = cq[np.asarray(keep)], ct[np.asarray(keep)]

    parts: list[np.ndarray] = []
    score = 0
    pq = pt = 0
    for i in range(len(cq) + 1):
        gq_end = int(cq[i]) if i < len(cq) else qn
        gt_end = int(ct[i]) if i < len(cq) else tn
        sub_ops, sub_score = sdp_align(
            q[pq:gq_end], t[pt:gt_end], scores,
            word=(7 if word > 7 else 5),
            no_recurse_under=no_recurse_under,
            max_hits_per_word=max_hits_per_word,
            _depth=_depth + 1,
        )
        parts.append(sub_ops)
        score += sub_score
        if i < len(cq):
            parts.append(np.full(word, OP_M, np.uint8))
            score += word * scores.match
            pq, pt = int(cq[i]) + word, int(ct[i]) + word
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8), score


def graph_paper_filter(
    qs: np.ndarray,
    ts: np.ndarray,
    lens: np.ndarray,
    n_rows: int = 40,
    n_cols: int = 40,
    min_score: int = 0,
    max_score: int = 1 << 30,
) -> np.ndarray:
    """Coarse-grid pre-filter for seed sets (role of reference
    ``GraphPaper`` — common/algorithms/alignment/GraphPaper.h:49-130):
    bin seeds into an (n_rows, n_cols) grid over the seed bounding box,
    run a diagonal/left/up max-score DP over bin masses (indel penalty =
    average bin mass), and keep only seeds whose cell lies on the optimal
    grid path. Returns a boolean mask over the input seeds.

    Used to thin pathological seed sets (repeat storms) before the exact
    sparse chain; colinear evidence survives, off-path noise drops.
    """
    n = len(qs)
    if n == 0:
        return np.zeros(0, bool)
    x = np.asarray(qs, np.int64)
    y = np.asarray(ts, np.int64)
    ln = np.asarray(lens, np.int64)
    x0, x1 = int(x.min()), int(x.max()) + 1
    y0, y1 = int(y.min()), int(y.max()) + 1
    ri = np.minimum(((x - x0) * n_rows) // max(x1 - x0, 1), n_rows - 1)
    ci = np.minimum(((y - y0) * n_cols) // max(y1 - y0, 1), n_cols - 1)
    bins = np.zeros((n_rows, n_cols), np.int64)
    np.add.at(bins, (ri, ci), ln)
    bins = np.minimum(bins, max_score)
    bins[bins < min_score] = 0
    pen = max(1, int(ln.sum()) // (n_rows * n_cols + 1))

    score = np.zeros((n_rows + 1, n_cols + 1), np.int64)
    move = np.zeros((n_rows + 1, n_cols + 1), np.int8)  # 0 diag 1 left 2 up
    for r in range(1, n_rows + 1):
        diag = score[r - 1, :-1] + bins[r - 1]
        up = score[r - 1, 1:] - pen
        row = score[r]
        best = np.maximum(diag, up)
        mv = np.where(diag >= up, 0, 2).astype(np.int8)
        acc = row[0]
        for c in range(1, n_cols + 1):
            left = acc - pen
            if best[c - 1] >= left:
                row[c] = best[c - 1]
                move[r, c] = mv[c - 1]
            else:
                row[c] = left
                move[r, c] = 1
            acc = row[c]
    # traceback, marking EVERY cell on the path (the reference Stars the
    # cell for diagonal, left and up moves alike, GraphPaper.h:163-171)
    on = np.zeros((n_rows, n_cols), bool)
    r, c = n_rows, n_cols
    while r > 0 and c > 0:
        on[r - 1, c - 1] = True
        m = move[r, c]
        if m == 0:
            r -= 1
            c -= 1
        elif m == 1:
            c -= 1
        else:
            r -= 1
    return on[ri, ci]
