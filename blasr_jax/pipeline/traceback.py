"""Host-side traceback replay (L4/L5 boundary).

The device DP (ops/banded_align.py) streams packed arrow bytes to HBM; this
module walks the stored arrows back from the best cell to recover the
alignment path — the same DP/traceback split the reference uses, with the
walk vectorized in lockstep across all items of a batch (every item advances
one step per iteration; finished items are masked).

Reference parity: blasr recovers paths inside each DP routine
(e.g. KBandAlign.h traceback loop); stats mirror ComputeAlignmentStats
(AlignmentUtils.h:536).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from blasr_jax.ops.banded_align import (
    SRC_DIAG,
    SRC_DIAG_START,
    SRC_E,
    SRC_F,
    SRC_LEFT,
    SRC_STOP,
    SRC_UP,
)

OP_M, OP_I, OP_D = 1, 2, 3


class AlignmentPath:
    """One banded alignment in local window coordinates.

    Half-open spans: query [q_start, q_end), target [t_start, t_end).
    ops: uint8 array of OP_M/OP_I/OP_D in start->end order. A path built
    from the device walk may instead carry the walk's 2-bit PACKED move
    string (END->START order) — ``ops`` then materializes lazily on first
    access, and consumers that can work from the packed form directly
    (native SAM field assembly) skip the unpack entirely.
    """

    __slots__ = (
        "q_start", "q_end", "t_start", "t_end", "score",
        "n_match", "n_mismatch", "n_ins", "n_del", "_ops",
        "packed", "packed_nops",
    )

    def __init__(
        self, q_start: int, q_end: int, t_start: int, t_end: int,
        ops: "np.ndarray | None", score: int,
        n_match: int = 0, n_mismatch: int = 0, n_ins: int = 0, n_del: int = 0,
        packed: "np.ndarray | None" = None, packed_nops: int = 0,
    ):
        self.q_start = q_start
        self.q_end = q_end
        self.t_start = t_start
        self.t_end = t_end
        self._ops = ops
        self.score = score
        self.n_match = n_match
        self.n_mismatch = n_mismatch
        self.n_ins = n_ins
        self.n_del = n_del
        self.packed = packed
        self.packed_nops = packed_nops

    @property
    def ops(self) -> np.ndarray:
        if self._ops is None:
            from blasr_jax.ops.traceback_device import unpack_moves

            self._ops = unpack_moves(self.packed, self.packed_nops)
        return self._ops

    @property
    def n_aligned(self) -> int:
        if self._ops is None:
            return self.packed_nops
        return len(self._ops)

    @property
    def pct_similarity(self) -> float:
        n = self.n_match + self.n_mismatch + self.n_ins + self.n_del
        return 100.0 * self.n_match / n if n else 0.0

    def cigar_runs(self) -> list[tuple[str, int]]:
        """Run-length encoded ops as (op_char, length), M/I/D."""
        ops = np.asarray(self.ops)
        if ops.size == 0:
            return []
        chars = {OP_M: "M", OP_I: "I", OP_D: "D"}
        ends = np.flatnonzero(np.diff(ops)) + 1
        bounds = np.concatenate(([0], ends, [ops.size]))
        return [
            (chars[int(ops[bounds[i]])], int(bounds[i + 1] - bounds[i]))
            for i in range(len(bounds) - 1)
        ]


def walk_traceback(
    arrows: np.ndarray,   # (S, I, W) uint8
    qoff: np.ndarray,     # (S,) int32
    best_a: np.ndarray,   # (I,) int32
    best_w: np.ndarray,   # (I,) int32
    scores_: np.ndarray,  # (I,) int32 best local scores
    query: np.ndarray,    # (I, L) uint8
    target: np.ndarray,   # (I, T) uint8
) -> list[AlignmentPath | None]:
    """Replay arrows for every item; None where no alignment (score >= 0)."""
    S, I, W = arrows.shape
    s1 = np.diff(qoff, prepend=qoff[:1]).astype(np.int64)  # s1[a] = qoff[a]-qoff[a-1]

    a = best_a.astype(np.int64).copy()
    w = best_w.astype(np.int64).copy()
    st = np.zeros(I, np.int8)       # 0=H, 1=E, 2=F
    active = scores_ < 0
    ops_rev = np.zeros((I, S + 2), np.uint8)
    nops = np.zeros(I, np.int64)
    ii = np.arange(I)

    max_iter = 2 * S + 4
    for _ in range(max_iter):
        if not active.any():
            break
        ac = np.clip(a, 0, S - 1)
        byte = arrows[ac, ii, np.clip(w, 0, W - 1)]
        src = byte & 7
        ebit = (byte >> 3) & 1
        fbit = (byte >> 4) & 1
        cs1 = s1[ac]
        cs2 = s1[np.clip(ac - 1, 0, S - 1)]

        emit = np.zeros(I, np.uint8)
        da = np.zeros(I, np.int64)
        dw = np.zeros(I, np.int64)
        new_st = st.copy()
        stop = np.zeros(I, bool)

        is_h = active & (st == 0)
        is_e = active & (st == 1)
        is_f = active & (st == 2)

        m = is_h & ((src == SRC_DIAG) | (src == SRC_DIAG_START))
        emit[m] = OP_M
        da[m] = -2
        dw[m] = (cs1 + cs2 - 1)[m]
        stop[is_h & (src == SRC_DIAG_START)] = True
        m = is_h & (src == SRC_UP)
        emit[m] = OP_I
        da[m] = -1
        dw[m] = (cs1 - 1)[m]
        m = is_h & (src == SRC_LEFT)
        emit[m] = OP_D
        da[m] = -1
        dw[m] = cs1[m]
        m = is_h & (src == SRC_E)
        new_st[m] = 1
        m = is_h & (src == SRC_F)
        new_st[m] = 2
        m = is_h & (src == SRC_STOP)
        stop[m] = True

        emit[is_e] = OP_D
        da[is_e] = -1
        dw[is_e] = cs1[is_e]
        new_st[is_e] = np.where(ebit[is_e] == 1, 1, 0)

        emit[is_f] = OP_I
        da[is_f] = -1
        dw[is_f] = (cs1 - 1)[is_f]
        new_st[is_f] = np.where(fbit[is_f] == 1, 2, 0)

        has_emit = emit > 0
        ops_rev[ii[has_emit], nops[has_emit]] = emit[has_emit]
        nops[has_emit] += 1

        a = a + da
        w = w + dw
        st = new_st
        # stop when flagged, or when the walk leaves the stored band
        active = active & ~stop & (a >= 0) & (w >= 0) & (w < W)

    out: list[AlignmentPath | None] = []
    for i in range(I):
        if scores_[i] >= 0 or nops[i] == 0:
            out.append(None)
            continue
        ops = ops_rev[i, : nops[i]][::-1].copy()
        q_end = int(qoff[best_a[i]] + best_w[i]) + 1
        t_end = int(best_a[i]) - (q_end - 1) + 1
        n_q = int(np.count_nonzero(ops != OP_D))
        n_t = int(np.count_nonzero(ops != OP_I))
        q_start = q_end - n_q
        t_start = t_end - n_t
        # stats: replay positions vectorized
        qstep = (ops != OP_D).astype(np.int64)
        tstep = (ops != OP_I).astype(np.int64)
        qpos = q_start + np.cumsum(qstep) - qstep
        tpos = t_start + np.cumsum(tstep) - tstep
        ism = ops == OP_M
        qc = query[i, qpos[ism]]
        tc = target[i, tpos[ism]]
        n_match = int(np.count_nonzero((qc == tc) & (qc < 4)))
        n_mm = int(np.count_nonzero(ism)) - n_match
        out.append(
            AlignmentPath(
                q_start=q_start,
                q_end=q_end,
                t_start=t_start,
                t_end=t_end,
                ops=ops,
                score=int(scores_[i]),
                n_match=n_match,
                n_mismatch=n_mm,
                n_ins=int(np.count_nonzero(ops == OP_I)),
                n_del=int(np.count_nonzero(ops == OP_D)),
            )
        )
    return out
