"""Gold-standard exhaustive alignment oracle (L8).

Role of reference ``gold_standard/ExhaustiveAlign.cpp`` (exhalign): compute
brute-force optimal local affine alignments to score mapper output against.
Pure numpy, O(L*T) per pair — deliberately simple and obviously correct;
also the unit-test oracle for the banded device kernels.
"""

from __future__ import annotations

import numpy as np

from blasr_jax.ops.banded_align import AlignScores

BIG = 10**9


def local_affine_score(q: np.ndarray, t: np.ndarray, sc: AlignScores) -> int:
    """Unbanded local min-score affine DP (identical cell semantics to the
    device kernel; see ops/banded_align.py recurrence)."""
    L, T = len(q), len(t)
    H = np.zeros((L + 1, T + 1), np.int64)
    E = np.full((L + 1, T + 1), BIG, np.int64)
    F = np.full((L + 1, T + 1), BIG, np.int64)
    best = 0
    for i in range(1, L + 1):
        qc = q[i - 1]
        for j in range(1, T + 1):
            E[i][j] = min(E[i][j - 1], H[i][j - 1] + sc.affine_open) + sc.affine_extend
            F[i][j] = min(F[i - 1][j], H[i - 1][j] + sc.affine_open) + sc.affine_extend
            tc = t[j - 1]
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
            if h < best:
                best = h
    return int(best)


def _qv_cost(base: int, q: int) -> int:
    """QualityValueScoreFunction role: banded_align.qv_scaled_costs."""
    return max((base * min(max(int(q), 4), 30) + 7) // 15, 1)


def banded_local_affine(
    q: np.ndarray,
    t: np.ndarray,
    sc: AlignScores,
    qoff: np.ndarray,
    W: int,
    qual: np.ndarray | None = None,
    tlo: int = 0,
    thi: int | None = None,
) -> tuple[int, int, int]:
    """Brute-force banded local affine DP, cell by cell, with the device
    kernels' band and scoring semantics; returns (score, best_a, best_w).

    Cell (i, j) (query i, target j) exists iff it lies in the band —
    ``qoff[i + j] <= i < qoff[i + j] + W`` — and ``tlo <= j < thi``; every
    other cell is unreachable. A diagonal step may always start fresh (the
    local boundary). ``qual`` scales the mismatch and insertion penalties
    per query base: one uint8 stream scales both, a uint16 stream carries
    mismatch qualities in its low byte and insertion qualities in its high
    byte. ``sc.matrix`` replaces the match/mismatch/N scores. The end cell
    is the first anti-diagonal ``a`` reaching the minimum, then its
    smallest band coordinate ``w = i - qoff[a]``.
    """
    L, T = len(q), len(t)
    thi = T if thi is None else thi
    INF = 2**30
    H = np.full((L + 1, T + 1), INF, np.int64)  # row/col 0: unreachable
    E = np.full((L + 1, T + 1), INF, np.int64)
    F = np.full((L + 1, T + 1), INF, np.int64)
    dual = qual is not None and qual.dtype == np.uint16
    for i in range(1, L + 1):
        qc = int(q[i - 1])
        x_cost, ins = sc.mismatch, sc.insertion
        if qual is not None:
            qv = int(qual[i - 1])
            x_cost = _qv_cost(sc.mismatch, qv & 255 if dual else qv)
            ins = _qv_cost(sc.insertion, qv >> 8 if dual else qv)
        for j in range(max(tlo, 0) + 1, min(thi, T) + 1):
            a = i + j - 2
            if not (qoff[a] <= i - 1 < qoff[a] + W):
                continue
            tc = int(t[j - 1])
            if sc.matrix is not None:
                sub = sc.matrix[qc * 5 + min(tc, 4)] if qc <= 4 else 0
            elif qc == tc and qc < 4:
                sub = sc.match
            elif qc >= 4 or tc >= 4:
                sub = sc.n_score
            else:
                sub = x_cost
            E[i][j] = min(E[i][j - 1], H[i][j - 1] + sc.affine_open) + sc.affine_extend
            F[i][j] = min(F[i - 1][j], H[i - 1][j] + sc.affine_open) + sc.affine_extend
            H[i][j] = min(
                min(H[i - 1][j - 1], 0) + sub,
                H[i - 1][j] + ins,
                H[i][j - 1] + sc.deletion,
                E[i][j],
                F[i][j],
                0,
            )
    best = int(min(H[1:, 1:].min(), 0))
    if best == 0:
        return 0, 0, 0
    ii, jj = np.nonzero(H == best)
    a = ii + jj - 2
    k = np.lexsort((ii, a))[0]
    return best, int(a[k]), int(ii[k] - 1 - qoff[a[k]])
