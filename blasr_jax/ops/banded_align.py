"""Banded affine-gap local alignment as a wavefront over anti-diagonals (L4).

Role of reference ``common/algorithms/alignment/KBandAlign.h`` /
``GuidedAlign.h`` / ``AffineKBandAlign.h`` (row-by-row banded DP with an
in-row sequential gap recurrence) — re-designed as an **anti-diagonal
wavefront**: every cell of anti-diagonal ``a = q + t`` depends only on
anti-diagonals ``a-1`` and ``a-2``, so the whole band (width W) updates as
pure element-wise vector ops, batched over items. One ``lax.scan`` over
``S = L + T - 1`` steps replaces the irregular per-read DP loop. This scan
is the plain reference; ``ops/banded_gpu.py`` is the GPU kernel that must
match it bit for bit.

Scoring matches the reference's SMRT model (ScoreMatrices.h:20-26 +
MappingParameters.h:202,338-340): minimization, match<0, mismatch>0,
linear indels, PLUS an affine gap pair (open+extend) that undercuts the
linear path for long gaps — both paths coexist exactly as in
AffineKBandAlign's three-matrix design. Local alignment is expressed as a
0-clamp (H = min(..., 0)) which subsumes all boundary initialisation.

Band placement: the band is centred on the candidate diagonal. Cell
``(a, w)`` is ``q = qoff[a] + w``, ``t = a - q`` (t in local target-window
coords). ``qoff`` is a static per-step offset array shared by all items
(the candidate diagonal is normalised into the target window by the
caller), so per-step band shifts are scalar selects, not gathers.

Traceback is *stored, not walked*, on device: a packed arrow word per cell
(3 bits H-source, 1 bit E-extend, 1 bit F-extend, 6 bits match-run length)
streams out per step; the device walk (ops/traceback_device.py) replays the
path, mirroring the reference's split between DP and path recovery.

The match-run field (bits 5-10) counts consecutive matching-diagonal moves
starting at the cell, capped at 63 (the move-slot count width): ``run >= 1`` iff the cell's move is a
diagonal MATCH, so the walk can emit ``run`` match ops and jump the whole
run in one serial step, and match/mismatch tallies come straight from the
byte (a mismatch diagonal has run 0) — no post-hoc sequence gathers.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

INF = np.int32(2**30)

# H-source codes stored in the arrow byte (priority order on ties)
SRC_DIAG, SRC_UP, SRC_LEFT, SRC_E, SRC_F, SRC_STOP = 0, 1, 2, 3, 4, 5
SRC_DIAG_START = 6  # diagonal move from a fresh (empty) local start


class AlignScores(NamedTuple):
    match: int = -5
    mismatch: int = 6
    n_score: int = 0        # vs-N column of the SMRT matrix
    insertion: int = 5      # consume query (read insertion)
    deletion: int = 5       # consume target (read deletion)
    affine_open: int = 50
    affine_extend: int = 0
    matrix: tuple | None = None  # optional 25-entry substitution matrix,
                            # row-major query x target over A C G T N
                            # (-scoreMatrix, StringToScoreMatrix.h:9-44);
                            # replaces match/mismatch/n_score when set


def matrix_sub(qwin: jax.Array, twin: jax.Array, mat: tuple) -> jax.Array:
    """Per-cell substitution score from a full 5x5 matrix (static selects —
    the matrix is compile-time constant, so this stays vectorizable)."""
    dt = qwin.dtype
    tcode = jnp.minimum(twin, 4)  # out-of-window sentinel -> N column
    sub = jnp.zeros(qwin.shape, dt)
    for qi in range(5):
        row = jnp.zeros(qwin.shape, dt)
        for ti in range(5):
            row = jnp.where(tcode == ti, jnp.asarray(mat[qi * 5 + ti], dt), row)
        sub = jnp.where(qwin == qi, row, sub)
    return sub


class BandedResult(NamedTuple):
    score: jax.Array    # (I,) int32 best local score (<= 0)
    best_a: jax.Array   # (I,) int32 anti-diagonal of alignment end cell
    best_w: jax.Array   # (I,) int32 band coord of alignment end cell
    arrows: Optional[jax.Array]  # (S, I, W) uint16 arrow words or None


def make_qoff(L: int, T: int, W: int, diag: int) -> np.ndarray:
    """Static band offsets: centre the band on local diagonal ``diag``.

    Returns int32 [S] with qoff[a+1] - qoff[a] in {0, 1}.
    """
    S = L + T - 1
    a = np.arange(S, dtype=np.int64)
    centre_q = (a - diag) // 2
    qoff = np.clip(centre_q - W // 2, 0, max(0, L - W)).astype(np.int32)
    return qoff


QOFF_SHIFT = 16  # fixed-point denominator bits of the drift-slope schedule
QOFF_NUM_HALF = 1 << (QOFF_SHIFT - 1)  # num for slope 0: centre_q=(a-diag)/2

KNOT_LOG2 = 6              # knot spacing (steps) of the per-item guided
KNOT_SPACING = 1 << KNOT_LOG2  # band schedule, as a power of two so the
                           # integer lerp is shift-only and EXACTLY
                           # reproducible by the traceback walk


def n_knots(S: int) -> int:
    """Knot count covering steps [0, S): ceil((S-1)/KS) + 1 segment ends."""
    return max(1, -(-(S - 1) // KNOT_SPACING)) + 1


def qoff_from_knots(knots: jax.Array, S: int) -> jax.Array:
    """Expand per-item knots (I, NK) into a per-item band schedule (S, I).

    Integer lerp: qoff(a) = (k0*(KS-r) + k1*r) >> KNOT_LOG2 with
    j = a >> KNOT_LOG2, r = a & (KS-1). Knots built by make_qoff_knots are
    nondecreasing with adjacent diffs <= KS, so per-step deltas are in
    {0, 1} — the invariant the DP and the walk rely on. The walk
    (ops/traceback_device.walk_arrows_device) evaluates the IDENTICAL
    formula per item so DP and walk agree exactly.
    """
    a = jnp.arange(S, dtype=jnp.int32)
    j = a >> KNOT_LOG2
    r = (a & (KNOT_SPACING - 1))[:, None]
    k0 = knots[:, :].T[j]                       # (S, I) via row gather
    k1 = knots[:, :].T[jnp.minimum(j + 1, knots.shape[1] - 1)]
    return ((k0 * (KNOT_SPACING - r) + k1 * r) >> KNOT_LOG2).astype(jnp.int32)


def make_qoff_knots(
    a_anchor: jax.Array,   # (I, A) int32 anchor anti-diagonals (window coords)
    v_anchor: jax.Array,   # (I, A) int32 desired band start at that step
    mask: jax.Array,       # (I, A) bool chain-consistent member anchors
    S: int,
    L: int,
    W: int,
    diag: int,             # shared-schedule diagonal (window pad2)
    num,                   # traced drift-slope numerator (QOFF_SHIFT fp)
) -> jax.Array:
    """Per-item guided band schedule knots from member anchors (the role of
    the reference's per-read AlignmentToGuide, GuidedAlign.h:104: the band
    follows each read's own anchor chain, so bursty indel drift that a
    straight batch line cannot track stays inside a narrow band).

    Between anchors the knot value interpolates linearly; beyond the first/
    last anchor it extends along the batch drift-slope line; items with no
    member anchors fall back to the shared line entirely. Knots are clipped
    to [0, L-W] and forced monotone with diffs <= KNOT_SPACING, which
    qoff_from_knots turns into per-step deltas in {0, 1}.
    """
    I, A = a_anchor.shape
    NK = n_knots(S)
    ak = (jnp.arange(NK, dtype=jnp.int32) * KNOT_SPACING)[None, :]  # (1, NK)
    numc = jnp.asarray(num, jnp.int32)

    big = jnp.int32(1 << 28)
    a_m = jnp.where(mask, a_anchor, big)
    order = jnp.argsort(a_m, axis=1)
    a_s = jnp.take_along_axis(a_m, order, axis=1)           # (I, A) sorted
    v_s = jnp.take_along_axis(
        jnp.where(mask, v_anchor, 0), order, axis=1
    )
    n_valid = mask.sum(axis=1).astype(jnp.int32)            # (I,)
    have = n_valid > 0

    # neighbour indices for every knot position (vectorized searchsorted:
    # count anchors with a <= ak)
    idx = (a_s[:, None, :] <= ak[:, :, None]).sum(axis=2).astype(jnp.int32)
    lo = jnp.clip(idx - 1, 0, A - 1)                        # (I, NK)
    hi = jnp.clip(jnp.minimum(idx, n_valid[:, None] - 1), 0, A - 1)
    a_lo = jnp.take_along_axis(a_s, lo, axis=1)
    a_hi = jnp.take_along_axis(a_s, hi, axis=1)
    v_lo = jnp.take_along_axis(v_s, lo, axis=1)
    v_hi = jnp.take_along_axis(v_s, hi, axis=1)

    inside = (idx >= 1) & (idx < n_valid[:, None])
    below = idx < 1                                          # before first
    span = jnp.maximum(a_hi - a_lo, 1)
    v_interp = v_lo + (ak - a_lo) * (v_hi - v_lo) // span
    # beyond the ends: extend along the batch drift line (dq/da = num/2^16)
    v_ext_lo = v_hi + (((ak - a_hi) * numc) >> QOFF_SHIFT)   # before first
    v_ext_hi = v_lo + (((ak - a_lo) * numc) >> QOFF_SHIFT)   # after last
    v = jnp.where(inside, v_interp, jnp.where(below, v_ext_lo, v_ext_hi))
    # no-anchor items: the shared line
    v_shared = (((ak - jnp.int32(diag)) * numc) >> QOFF_SHIFT) - W // 2
    v = jnp.where(have[:, None], v, v_shared)

    v = jnp.clip(v, 0, max(0, L - W))
    # monotone with bounded slope: cummax then cap diffs at KNOT_SPACING
    v = jax.lax.cummax(v, axis=1)
    d = jnp.clip(jnp.diff(v, axis=1), 0, KNOT_SPACING)
    return jnp.concatenate(
        [v[:, :1], v[:, :1] + jnp.cumsum(d, axis=1)], axis=1
    ).astype(jnp.int32)


def make_qoff_num(L: int, T: int, W: int, diag: int, num) -> "jax.Array":
    """Drift-slope band schedule (role of the reference's drift-following
    Guide, GuidedAlign.h:104 AlignmentToGuide): the band centre follows
    ``t = (1 + slope) q + diag`` with ``num = round(2^16 / (2 + slope))``,
    so systematic ins/del drift (PacBio ins-rate > del-rate) stays centred
    and the band can be narrow. ``num`` may be a traced scalar (estimated
    per batch from the anchor chains on device); the identical integer
    formula is evaluated by the traceback walk
    (ops/traceback_device.walk_arrows_device) so DP and walk agree exactly.

    num = QOFF_NUM_HALF reproduces make_qoff bit-for-bit.
    """
    S = L + T - 1
    a = jnp.arange(S, dtype=jnp.int32)
    centre_q = ((a - jnp.int32(diag)) * jnp.asarray(num, jnp.int32)) >> QOFF_SHIFT
    return jnp.clip(centre_q - W // 2, 0, max(0, L - W)).astype(jnp.int32)


def knot_clamp_bound(W: int) -> int:
    """Largest deviation of a per-item knot from the shared schedule.

    ``W - 8`` for full bands; the narrow bands keep a wider clamp (88 at
    W = 32, 120 at W = 64) so that a guided narrow band can still follow a
    read's own drift. The mapper's records were produced with these bounds.
    """
    return {32: 88, 64: 120}.get(W, W - 8)


def clamp_knots_to_shared(
    knots: jax.Array, qoff_shared: jax.Array, W: int
) -> jax.Array:
    """Clamp per-item knots to within ``knot_clamp_bound(W)`` of the shared
    schedule's value at each knot step. Clamping two monotone sequences
    preserves monotonicity and the <= KNOT_SPACING step bound, so the
    {0, 1} per-step delta invariant survives. Must be applied BEFORE the
    schedule is used anywhere (DP and walk see identical schedules)."""
    S = qoff_shared.shape[0]
    NK = knots.shape[1]
    ak = jnp.minimum(
        jnp.arange(NK, dtype=jnp.int32) * KNOT_SPACING, S - 1
    )
    ks = qoff_shared[ak][None, :]
    c = knot_clamp_bound(W)
    return jnp.clip(knots, ks - c, ks + c)


def qv_scaled_costs(base: jax.Array, qual: jax.Array) -> jax.Array:
    """QV-scaled penalty (role of QualityValueScoreFunction.h:65,80-84:
    penalties proportional to the base's quality value — confident bases
    are expensive to mismatch/insert, noisy bases cheap).

    cost = max(1, base * clip(qual, 4, 30) / 15): qual 15 reproduces the
    unscaled penalty, saturating at 2x for qual >= 30.
    """
    qv = jnp.clip(qual.astype(jnp.int32), 4, 30)
    return jnp.maximum((base * qv + 7) // 15, 1)


@functools.partial(
    jax.jit,
    static_argnames=("scores", "with_traceback", "band_width", "global_q"),
)
def banded_align(
    query: jax.Array,    # (I, L) uint8 codes 0..4
    qlen: jax.Array,     # (I,) int32
    target: jax.Array,   # (I, T) uint8 codes 0..5 (5 = out-of-window sentinel)
    tlo: jax.Array,      # (I,) int32 valid target range start (local coords)
    thi: jax.Array,      # (I,) int32 valid target range end (local coords)
    qoff: jax.Array,     # (S,) int32 static band offsets (see make_qoff)
    qual: jax.Array | None = None,  # (I, L) uint8 phred, or None
    *,
    scores: AlignScores = AlignScores(),
    with_traceback: bool = False,
    band_width: int = 128,
    global_q: bool = False,  # GLOBAL-IN-QUERY score mode (score-only): the
                             # alignment must consume every query base
                             # (leading/trailing bases enter via the virtual
                             # q=-1 boundary row / end-row tracking), target
                             # start+end stay free. This is the reference's
                             # "hybrid of global/local" refinement score
                             # (AlignIntervals + extension, the value the
                             # -maxScore print gate tests) — a secondary
                             # whose seed supports only part of the read
                             # rescores far above its best LOCAL subpath.
) -> BandedResult:
    if global_q:
        assert not with_traceback, "global_q is a score-only mode"
    I, L = query.shape
    T = target.shape[1]
    S = int(qoff.shape[0])
    assert S == L + T - 1
    W = band_width
    # qoff (S,): one shared schedule (shifts are scalar selects). qoff
    # (S, I): per-item guided schedules (make_qoff_knots/qoff_from_knots —
    # the GuidedAlign.h:104 per-read guide role); window fetches become
    # per-item gathers and band shifts 3-way selects on the per-item delta.
    per_item = qoff.ndim == 2

    inf = jnp.int32(INF)
    qext = jnp.pad(query, ((0, 0), (0, W)), constant_values=4).astype(jnp.int8)
    quext = None
    qual_dual = qual is not None and qual.dtype == jnp.uint16
    if qual_dual:
        # two packed phred streams (IDS scoring, IDSScoreFunction.h role):
        # low byte scales mismatches (sq), high byte insertions (iq)
        quext = jnp.pad(
            qual, ((0, 0), (0, W)), constant_values=15 | (15 << 8)
        ).astype(jnp.uint16)
    elif qual is not None:
        quext = jnp.pad(qual, ((0, 0), (0, W)), constant_values=15).astype(jnp.uint8)
    # reversed padded target: trev[:, j] = tpad[:, Tp-1-j]; see offset math below
    tpad = jnp.pad(target, ((0, 0), (W, W)), constant_values=5).astype(jnp.int8)
    trev = tpad[:, ::-1]
    Tp = T + 2 * W

    s1_arr = jnp.diff(qoff, axis=0, prepend=qoff[:1])  # 0/1 deltas, s1[0] = 0
    s2_arr = jnp.concatenate(
        [jnp.zeros_like(s1_arr[:1]), s1_arr[:-1]], axis=0
    )
    a_arr = jnp.arange(S, dtype=jnp.int32)

    w_ar = jnp.arange(W, dtype=jnp.int32)[None, :]     # (1, W)
    qlen_c = qlen[:, None]
    tlo_c = tlo[:, None]
    thi_c = thi[:, None]

    m_sc = jnp.int32(scores.match)
    x_sc = jnp.int32(scores.mismatch)
    n_sc = jnp.int32(scores.n_score)
    ins_sc = jnp.int32(scores.insertion)
    del_sc = jnp.int32(scores.deletion)
    go = jnp.int32(scores.affine_open)
    ge = jnp.int32(scores.affine_extend)

    def shift(x, dlt, fill=INF):
        """Value at band index w + dlt (dlt traced scalar in {-1, 0, 1})."""
        xp = jnp.pad(x, ((0, 0), (1, 1)), constant_values=fill)
        return jax.lax.dynamic_slice_in_dim(xp, 1 + dlt, W, axis=1)

    def shift_i(x, dlt, fill=INF):
        """shift() for a per-item delta vector (values in {-1, 0, 1})."""
        d = dlt[:, None]
        out = jnp.where(d == -1, shift(x, jnp.int32(-1), fill), x)
        return jnp.where(d == 1, shift(x, jnp.int32(1), fill), out)

    def step(carry, xs):
        H1, H2, E1, F1, R1, R2, M1, M2, best, besta, bestw = carry
        a, qo, s1, s2 = xs

        if per_item:
            gidx = qo[:, None] + w_ar                   # (I, W)
            qwin = jnp.take_along_axis(qext, gidx, axis=1)
            tstart = (Tp - 1 - W) - (a - qo)            # (I,)
            twin = jnp.take_along_axis(trev, tstart[:, None] + w_ar, axis=1)
            quwin = (
                jnp.take_along_axis(quext, gidx, axis=1)
                if quext is not None else None
            )
        else:
            qwin = jax.lax.dynamic_slice_in_dim(qext, qo, W, axis=1)
            # t = a - qo - w  ->  trev index = (Tp - 1 - W) - (a - qo) + w
            tstart = (Tp - 1 - W) - (a - qo)
            twin = jax.lax.dynamic_slice_in_dim(trev, tstart, W, axis=1)
            quwin = (
                jax.lax.dynamic_slice_in_dim(quext, qo, W, axis=1)
                if quext is not None else None
            )
        if quwin is not None:
            if qual_dual:
                qi = quwin.astype(jnp.int32)
                x_cell = qv_scaled_costs(x_sc, qi & 255)
                ins_cell = qv_scaled_costs(ins_sc, qi >> 8)
            else:
                x_cell = qv_scaled_costs(x_sc, quwin)
                ins_cell = qv_scaled_costs(ins_sc, quwin)
        else:
            x_cell = x_sc
            ins_cell = ins_sc

        q_pos = (qo[:, None] if per_item else qo) + w_ar  # (1->I, W)
        t_pos = a - q_pos
        valid = (q_pos < qlen_c) & (t_pos >= tlo_c) & (t_pos < thi_c) & (t_pos >= 0)

        eq = (qwin == twin) & (qwin < 4)
        if scores.matrix is not None:
            sub = matrix_sub(qwin, twin, scores.matrix)
        else:
            anyn = (qwin >= 4) | (twin >= 4)
            sub = jnp.where(eq, m_sc, jnp.where(anyn, n_sc, x_cell))

        sh = shift_i if per_item else shift
        H1_up = sh(H1, s1 - 1)
        H1_left = sh(H1, s1)
        E1_left = sh(E1, s1)
        F1_up = sh(F1, s1 - 1)
        H2_diag = sh(H2, s1 + s2 - 1)
        R2_diag = sh(R2, s1 + s2 - 1, fill=0)
        M2_diag = sh(M2, s1 + s2 - 1, fill=0)

        e_open = H1_left + go
        E_new = jnp.minimum(E1_left, e_open) + ge
        ebit = (E1_left <= e_open).astype(jnp.int32)
        f_open = H1_up + go
        F_new = jnp.minimum(F1_up, f_open) + ge
        fbit = (F1_up <= f_open).astype(jnp.int32)

        if global_q:
            # virtual boundary row H(q = -1, t) = 0 (free target start): at
            # q == 0 the diagonal and the insertion-family predecessors come
            # from it; elsewhere no free restarts and no 0-clamp
            at_q0 = q_pos == 0
            H2d_g = jnp.where(at_q0, 0, H2_diag)
            up_g = jnp.where(at_q0, 0, H1_up)
            f_open_g = up_g + go
            F_new = jnp.minimum(jnp.where(at_q0, inf, F1_up), f_open_g) + ge
            h = H2d_g + sub
            src = jnp.broadcast_to(jnp.int32(SRC_DIAG), h.shape)
            for val, code in (
                (up_g + ins_cell, SRC_UP),
                (H1_left + del_sc, SRC_LEFT),
                (E_new, SRC_E),
                (F_new, SRC_F),
            ):
                take = val < h
                h = jnp.minimum(h, val)
                src = jnp.where(take, code, src)
        else:
            # The diagonal predecessor may be an empty local start (score 0):
            # this is the local-alignment boundary condition, uniform across
            # the whole band. A fresh start gets its own source code so
            # traceback terminates after emitting the first M.
            diag_fresh = H2_diag > 0  # INF marks out-of-band/masked preds
            h = jnp.minimum(H2_diag, 0) + sub
            src = jnp.where(diag_fresh, SRC_DIAG_START, SRC_DIAG)
            for val, code in (
                (H1_up + ins_cell, SRC_UP),
                (H1_left + del_sc, SRC_LEFT),
                (E_new, SRC_E),
                (F_new, SRC_F),
            ):
                take = val < h
                h = jnp.minimum(h, val)
                src = jnp.where(take, code, src)
            # empty alignment wins all ties at 0 (trims zero-sum prefixes)
            take_stop = h >= 0
            h = jnp.minimum(h, 0)
            src = jnp.where(take_stop, SRC_STOP, src)

        H_new = jnp.where(valid, h, inf)
        E_new = jnp.where(valid, E_new, inf)
        F_new = jnp.where(valid, F_new, inf)
        src = jnp.where(valid, src, SRC_STOP)
        # diagonal-run length (bits 5-10) + mismatches inside the run
        # (bits 11-15): the walk jumps whole diagonal runs INCLUDING
        # mismatches and recovers exact match/mismatch tallies from the
        # mismatch count. Chains restart when either field would overflow,
        # so every stored (run, mcount) covers exactly the last `run`
        # diagonal moves.
        is_diag = src == SRC_DIAG
        mm = (~eq).astype(jnp.int32)
        restart = (R2_diag >= 63) | (M2_diag >= 31)
        R_new = jnp.where(
            is_diag, jnp.where(restart, 1, R2_diag + 1), 0
        ).astype(jnp.int32)
        # carried M counts mismatches along SRC_DIAG chains only; a
        # DIAG_START predecessor contributes 0 (its own bit is emitted in
        # ITS arrow word and tallied by the walk's start branch — seeding
        # it into the chain would double-count it in the successor run)
        M_new = jnp.where(
            is_diag, jnp.where(restart, mm, M2_diag + mm), 0
        ).astype(jnp.int32)
        # emitted mcount: chain count, or the start cell's own bit (with a
        # -scoreMatrix carrying negative off-diagonals a local alignment
        # can legally START on a mismatch)
        M_emit = jnp.where(src == SRC_DIAG_START, mm, M_new)

        if global_q:
            # termination cells: the alignment consumed the whole query
            # (q == qlen - 1); target end stays free so every step's last
            # query row competes
            H_end = jnp.where(q_pos == qlen_c - 1, H_new, inf)
            row_min = jnp.min(H_end, axis=1)
            row_arg = jnp.argmin(H_end, axis=1).astype(jnp.int32)
        else:
            row_min = jnp.min(H_new, axis=1)
            row_arg = jnp.argmin(H_new, axis=1).astype(jnp.int32)
        better = row_min < best
        best = jnp.minimum(best, row_min)
        besta = jnp.where(better, a, besta)
        bestw = jnp.where(better, row_arg, bestw)

        out = None
        if with_traceback:
            out = (
                src | (ebit << 3) | (fbit << 4) | (R_new << 5) | (M_emit << 11)
            ).astype(jnp.uint16)
        return (
            H_new, H1, E_new, F_new, R_new, R1, M_new, M1, best, besta, bestw
        ), out

    init = (
        jnp.full((I, W), INF, jnp.int32),
        jnp.full((I, W), INF, jnp.int32),
        jnp.full((I, W), INF, jnp.int32),
        jnp.full((I, W), INF, jnp.int32),
        jnp.zeros((I, W), jnp.int32),
        jnp.zeros((I, W), jnp.int32),
        jnp.zeros((I, W), jnp.int32),
        jnp.zeros((I, W), jnp.int32),
        # local scores are <= 0 (empty alignment); global-in-query scores
        # can be arbitrarily positive, so the running best starts at INF
        jnp.full(I, INF, jnp.int32) if global_q else jnp.zeros(I, jnp.int32),
        jnp.zeros(I, jnp.int32),
        jnp.zeros(I, jnp.int32),
    )
    xs = (a_arr, qoff, s1_arr, s2_arr)
    carry, arrows = jax.lax.scan(step, init, xs)
    best, besta, bestw = carry[-3:]
    return BandedResult(best, besta, bestw, arrows)
