"""On-device traceback walk over stored arrow bytes (L4).

The reference recovers paths with an in-DP pointer walk on the host CPU
(e.g. KBandAlign.h traceback loop). Here the arrow tensor produced by the
wavefront DP (ops/banded_align.py) stays in device memory, far too large to
ship to the host, so the walk runs on device as a ``lax.while_loop``
vectorized across all alignments of a batch; only a 2-bit-packed move
string (~1% of the arrow bytes) plus scalar stats leave the device.

The walk is a serial pointer chase — per sub-step cost is dominated by the
one random HBM gather into the arrow tensor. Everything else is engineered
away: the band-offset schedule is evaluated in closed form
(qoff(a) = clip((a - diag) >> 1 - W/2, 0, L - W), see
banded_align.make_qoff) instead of two table gathers; a whole run of
matching diagonal moves (run field of the arrow word, bits 5-10) is
emitted as ONE run-length slot and jumped in ONE sub-step; match/mismatch
tallies accumulate in-loop from the run field (run >= 1 iff matching
diagonal), so no post-hoc query/target gathers are needed at all; and the
emitted slot is scattered as a BOUNDARY CODE directly at its expanded
op position (the walk tracks each item's cumulative op count), so the
post-walk RLE expansion is one cummax + mask + 2-bit pack
(``pack_codes_rows``) with no big scatter at all — a bulk scatter of the
(I, 2S) slot matrix is replaced by one (I,)-row write per sub-step inside
the latency-bound loop.

Alignment stats mirror ComputeAlignmentStats (AlignmentUtils.h:536).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
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

OP_NONE, OP_M, OP_I, OP_D = 0, 1, 2, 3

WALK_UNROLL = int(os.environ.get("BLASR_WALK_UNROLL", "8"))  # sub-steps per
# while iteration (amortizes cond overhead); env for hardware sweeps


class DeviceTraceback(NamedTuple):
    """Compact per-alignment traceback (device arrays, host-transfer ready).

    moves_codes holds one RUN BOUNDARY CODE per emitted run, scattered at
    the run's expanded op position (END->START order): column p of row i is
    ``((p + 1) << 2) | op`` if a run starts at expanded position p, else 0.
    A row-wise cummax therefore reconstructs the covering run's op at every
    position; ``pack_codes_rows`` turns selected rows into the 2-bit
    per-op wire format. Spans are half-open local window coordinates like
    AlignmentPath; ``nops`` counts EXPANDED ops (= the expanded width).
    """

    moves_codes: jax.Array  # (I, 4*packed_width(S)+1) int32 boundary codes
    nops: jax.Array          # (I,) int32
    q_start: jax.Array       # (I,) int32
    q_end: jax.Array         # (I,) int32
    t_start: jax.Array       # (I,) int32
    t_end: jax.Array         # (I,) int32
    n_match: jax.Array       # (I,) int32
    n_mismatch: jax.Array    # (I,) int32
    n_ins: jax.Array         # (I,) int32
    n_del: jax.Array         # (I,) int32


def packed_width(S: int) -> int:
    S2 = S + 3
    return (S2 + 3) // 4


@functools.partial(jax.jit, static_argnames=("qoff_params",))
def walk_arrows_device(
    arrows: jax.Array,   # (S, IA, W) uint16
    qoff: jax.Array,     # (S,) int32
    best_a: jax.Array,   # (I,) int32
    best_w: jax.Array,   # (I,) int32
    scores: jax.Array,   # (I,) int32 (< 0 where an alignment exists)
    query: jax.Array,    # (I, L) uint8
    target: jax.Array,   # (I, T) uint8
    item_idx: jax.Array | None = None,  # (I,) int32 column of each walk in arrows
    qoff_params: tuple[int, int, int] | None = None,  # (diag, W_band, L_q)
    qoff_num: jax.Array | None = None,  # traced slope numerator (QOFF_SHIFT fp)
    qoff_knots: jax.Array | None = None,  # (I, NK) per-item guided knots
) -> DeviceTraceback:
    """Walk I paths through an (S, IA, W) arrow tensor.

    item_idx maps walk i -> arrow column (IA >= I), so a walk over a
    selected subset reads the full-candidate arrow tensor in place.
    qoff_params, when given, must describe the make_qoff schedule that
    produced ``qoff`` — the walk then computes band offsets analytically
    (two fewer gathers per serial step); with ``qoff_num`` the analytic
    form is the drift-slope schedule (banded_align.make_qoff_num) with the
    identical fixed-point arithmetic.
    """
    S, IA, W = arrows.shape
    I = best_a.shape[0]
    L = query.shape[1]
    T = target.shape[1]
    rows = jnp.arange(I, dtype=jnp.int32)           # walk-local row index
    ii = rows if item_idx is None else item_idx.astype(jnp.int32)  # arrow column
    flat = arrows.reshape(-1)

    if qoff_knots is not None:
        # per-item guided schedule: the IDENTICAL integer knot lerp as
        # banded_align.qoff_from_knots, evaluated per (item, step) — two
        # small-table gathers per call
        from blasr_jax.ops.banded_align import KNOT_LOG2, KNOT_SPACING

        NK = qoff_knots.shape[1]
        kflat = qoff_knots.reshape(-1)
        base = rows * NK

        def qoff_at(a):
            ac_ = jnp.clip(a, 0, S - 1)
            j = ac_ >> KNOT_LOG2
            r = ac_ & (KNOT_SPACING - 1)
            k0 = kflat[base + j]
            k1 = kflat[base + jnp.minimum(j + 1, NK - 1)]
            return ((k0 * (KNOT_SPACING - r) + k1 * r) >> KNOT_LOG2).astype(
                jnp.int32
            )

        def s1_at(a):
            return qoff_at(a) - qoff_at(a - 1)

    elif qoff_params is not None:
        # NOTE: named diag0 (not "diag") — substep() below binds a boolean
        # named diag and calls qoff_at, which closes over this scalar; the
        # distinct name makes a collision impossible under refactors
        diag0, Wb, Lq = qoff_params
        hi = max(0, Lq - Wb)

        if qoff_num is not None:
            from blasr_jax.ops.banded_align import QOFF_SHIFT

            numc = jnp.asarray(qoff_num, jnp.int32)

            def qoff_at(a):
                cq = ((a - diag0) * numc) >> QOFF_SHIFT  # arithmetic shift floors
                return jnp.clip(cq - Wb // 2, 0, hi).astype(jnp.int32)

        else:

            def qoff_at(a):
                # floor-div of possibly-negative (a - diag0); jnp // floors
                return jnp.clip((a - diag0) // 2 - Wb // 2, 0, hi).astype(jnp.int32)

        def s1_at(a):
            return qoff_at(a) - qoff_at(a - 1)
    else:
        s1_tab = jnp.diff(qoff, prepend=qoff[:1]).astype(jnp.int32)  # (S,)

        def qoff_at(a):
            return qoff[jnp.clip(a, 0, S - 1)]

        def s1_at(a):
            return s1_tab[jnp.clip(a, 0, S - 1)]

    max_iter = 2 * S + 4
    NIT = -(-max_iter // WALK_UNROLL)
    OW = packed_width(S)
    S2 = 4 * OW                                     # expanded op capacity

    def cond(carry):
        a, w, st, active, stats, mv, mp, it = carry
        return jnp.any(active) & (it < NIT)

    def substep(a, w, st, active, stats):
        nmatch, nmis, nins, ndel = stats
        ac = jnp.clip(a, 0, S - 1)
        wc = jnp.clip(w, 0, W - 1)
        byte = flat[(ac * IA + ii) * W + wc].astype(jnp.int32)
        src = byte & 7
        ebit = (byte >> 3) & 1
        fbit = (byte >> 4) & 1
        run = (byte >> 5) & 63                       # diagonal-run length
        mcount = byte >> 11                          # mismatches in the run
        cs1 = s1_at(ac)

        is_h = st == 0
        is_e = st == 1
        is_f = st == 2
        diag = is_h & ((src == SRC_DIAG) | (src == SRC_DIAG_START))
        up = is_h & (src == SRC_UP)
        left = is_h & (src == SRC_LEFT)
        to_e = is_h & (src == SRC_E)
        to_f = is_h & (src == SRC_F)
        h_stop = is_h & (src == SRC_STOP)

        # a DIAG_START cell carries its own (mis)match bit in mcount
        # (under the default scores a local alignment can only start on a
        # match, but a -scoreMatrix with negative off-diagonals can start
        # one on a mismatch); a SRC_DIAG cell carries its diagonal-run
        # length (>= 1) and the mismatches inside the run, which EXCLUDE
        # any DIAG_START cell at the run's origin. Whole runs — mismatches
        # included — jump in one sub-step.
        is_start = is_h & (src == SRC_DIAG_START)
        r_eff = jnp.where(
            diag, jnp.where(is_start, 1, jnp.maximum(run, 1)), 0
        ).astype(jnp.int32)
        op = jnp.where(
            diag, OP_M,
            jnp.where(up | is_f, OP_I, jnp.where(left | is_e, OP_D, OP_NONE)),
        ).astype(jnp.int32)
        cnt = jnp.where(diag, r_eff, jnp.where(op > 0, 1, 0))

        da = jnp.where(diag, -2 * r_eff, jnp.where(to_e | to_f | h_stop, 0, -1))
        dw_diag = qoff_at(ac) - qoff_at(ac - 2 * r_eff) - r_eff
        dw = jnp.where(
            diag, dw_diag,
            jnp.where(up | is_f, cs1 - 1, jnp.where(left | is_e, cs1, 0)),
        )
        new_st = jnp.where(
            is_h,
            jnp.where(to_e, 1, jnp.where(to_f, 2, 0)),
            jnp.where(is_e, jnp.where(ebit == 1, 1, 0), jnp.where(fbit == 1, 2, 0)),
        ).astype(jnp.int32)
        stop = is_start | h_stop

        cnt = jnp.where(active, cnt, 0)
        live = active.astype(jnp.int32)
        # r_eff is 1 for DIAG_START cells, whose arrow word carries its
        # own mismatch bit — uniform (run - mcount) match accounting
        nmatch = nmatch + live * jnp.where(diag, r_eff - mcount, 0)
        nmis = nmis + live * jnp.where(diag, mcount, 0)
        nins = nins + live * (up | is_f).astype(jnp.int32)
        ndel = ndel + live * (left | is_e).astype(jnp.int32)
        a = jnp.where(active, a + da, a)
        w = jnp.where(active, w + dw, w)
        st = jnp.where(active, new_st, st)
        active = active & ~stop & (a >= 0) & (w >= 0) & (w < W)
        return a, w, st, active, (nmatch, nmis, nins, ndel), op, cnt

    def body(carry):
        a, w, st, active, stats, mv, mp, it = carry
        idxs, vals = [], []
        for _ in range(WALK_UNROLL):
            a, w, st, active, stats, op, cnt = substep(a, w, st, active, stats)
            # boundary code at the run's expanded op position; non-emitting
            # sub-steps target the dump column S2 with value 0
            emit = cnt > 0
            idxs.append(jnp.where(emit, jnp.minimum(mp, S2 - 1), S2))
            vals.append(jnp.where(emit, ((mp + 1) << 2) | op, 0))
            mp = mp + cnt
        # ONE batched scatter per body iteration: the unrolled sub-steps'
        # writes land together instead of paying one op each inside this
        # latency-bound loop.
        # In-block index collisions happen only on the dump column, where
        # every colliding value is 0.
        mv = mv.at[rows[:, None], jnp.stack(idxs, axis=1)].set(
            jnp.stack(vals, axis=1)
        )
        return a, w, st, active, stats, mv, mp, it + 1

    zeros = jnp.zeros(I, jnp.int32)
    init = (
        best_a.astype(jnp.int32),
        best_w.astype(jnp.int32),
        jnp.zeros(I, jnp.int32),
        scores < 0,
        (zeros, zeros, zeros, zeros),
        jnp.zeros((I, S2 + 1), jnp.int32),
        zeros,
        jnp.int32(0),
    )
    _, _, _, _, stats, mv, _, _ = jax.lax.while_loop(cond, body, init)
    n_match, n_mismatch, n_ins, n_del = stats
    n_mops = n_match + n_mismatch

    q_end = qoff_at(jnp.clip(best_a, 0, S - 1)) + best_w + 1
    t_end = best_a - (q_end - 1) + 1
    q_start = q_end - (n_mops + n_ins)
    t_start = t_end - (n_mops + n_del)

    return DeviceTraceback(
        moves_codes=mv,
        nops=(n_mops + n_ins + n_del).astype(jnp.int32),
        q_start=q_start.astype(jnp.int32),
        q_end=q_end.astype(jnp.int32),
        t_start=t_start.astype(jnp.int32),
        t_end=t_end.astype(jnp.int32),
        n_match=n_match,
        n_mismatch=n_mismatch,
        n_ins=n_ins,
        n_del=n_del,
    )


@functools.partial(jax.jit, static_argnames=("out_width",))
def pack_codes_rows(
    codes: jax.Array, nops: jax.Array, out_width: int
) -> jax.Array:
    """Expand (I2, >=4*out_width) boundary-code rows (see DeviceTraceback:
    column p holds ``((p+1)<<2) | op`` iff a run starts at expanded position
    p) into the 2-bit per-op wire format (I2, out_width) — run on the
    SELECTED rows only.

    Codes are strictly increasing along each row wherever nonzero, so one
    cummax fills every run with its covering code; positions at or past
    ``nops`` (the expanded length) are zeroed; then 2-bit pack 4/byte.
    """
    I2 = codes.shape[0]
    S2 = 4 * out_width
    filled = jax.lax.cummax(codes[:, :S2], axis=1)
    pos = jnp.arange(S2, dtype=jnp.int32)[None, :]
    expanded = jnp.where(pos < nops[:, None], filled & 3, 0)
    mvp = expanded.reshape(I2, out_width, 4)
    shifts = jnp.array([0, 2, 4, 6], jnp.int32)
    return jnp.sum(mvp << shifts[None, None, :], axis=2).astype(jnp.uint8)


def unpack_moves(packed_row: np.ndarray, nops: int) -> np.ndarray:
    """Host-side: unpack one move string to START->END op order (uint8)."""
    from blasr_jax import native

    out = native.unpack_moves(packed_row, nops)
    if out is not None:
        return out
    b = packed_row[:, None] >> np.array([0, 2, 4, 6], np.uint8)[None, :]
    ops_rev = (b & 3).reshape(-1)[:nops]
    return ops_rev[::-1].copy()
