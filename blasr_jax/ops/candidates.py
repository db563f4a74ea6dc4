"""Candidate-interval selection from anchors (L3).

Role of reference ``common/algorithms/anchoring/FindMaxInterval.h``
(StoreLargestIntervals :395-540 windowed clustering + FindMaxIncreasingInterval
:661-844 chaining + WeightedIntervalSet top-nCandidates) — re-designed as a
fully vectorized diagonal-window sweep:

  1. each anchor (t, q) lies on genome diagonal d = t - q; a correct mapping's
     anchors cluster within a diagonal window of width ~= DP band
  2. per read, compute for every anchor i the summed anchor weight inside
     the window [d_i, d_i + win) as ONE fused masked reduce:
     win_w[i] = sum_j w_j * [0 <= d_j - d_i < win] — no sort, no binary
     search, no serial scan, and the (A, A) mask fuses into the sum
  3. pick the top-C windows by weight with non-maximum suppression (a small
     static python loop of C argmax/mask steps, fully batched over reads)

Weight = sum of 1/nhits per anchor, approximating the reference's p-value
weighting (LISPValueWeightor, LISPValue.h:86+) where rarer k-mers carry more
evidence. The DP band downstream absorbs anything the window blurs.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class Candidates(NamedTuple):
    """Per-(read-row, candidate): a target window to align against.

    All arrays shaped (B, C).
    """

    d0: jax.Array       # int32 representative diagonal (weighted mean)
    q_lo: jax.Array     # int32 min read pos among member anchors
    q_hi: jax.Array     # int32 max read pos + k among member anchors
    weight: jax.Array   # f32 summed anchor weight
    n_anchors: jax.Array  # int32 member count
    valid: jax.Array    # bool
    dstar: jax.Array    # int32 window-start diagonal (membership test:
                        # 0 <= (t - q) - dstar < win, matching the sweep)


@functools.partial(jax.jit, static_argnames=("n_candidates", "win", "k"))
def select_candidates(
    t: jax.Array,        # (B, A) int32 anchor genome pos
    q: jax.Array,        # (B, A) int32 anchor read pos
    weight: jax.Array,   # (B, A) f32 per-anchor evidence weight (see
                         # anchor_weights below — the weightor's output)
    valid: jax.Array,    # (B, A) bool
    *,
    n_candidates: int,
    win: int,            # diagonal window width (~ DP band width)
    k: int,              # anchor k-mer length
) -> Candidates:
    B, A = t.shape
    BIG = jnp.int32(2**30)

    d = t - q
    ds = jnp.where(valid, d, BIG)                      # (B, A)
    ws = jnp.where(valid, weight, 0.0)
    qs = q

    # window weight for the window starting at every anchor's diagonal:
    # win_w[i] = sum_j ws[j] * [0 <= ds[j] - ds[i] < win], a where+sum
    # that XLA fuses into one reduction (no (B, A, A) mask in memory).
    # Invalid anchors carry ds = BIG: never a member (delta out of range,
    # ws 0) and their own window is masked below.
    delta = ds[:, None, :] - ds[:, :, None]            # (B, win_i, anchor_j)
    member_m = (delta >= 0) & (delta < win)
    # float sums: the order of the reduction can differ between backends,
    # so equal-weight windows may rank differently across CPU and GPU
    # (weights are sums of 1/nhits; ties break by the top-C selection).
    win_w = jnp.sum(
        jnp.where(member_m, ws[:, None, :], 0.0), axis=-1
    )
    win_w = jnp.where(valid, win_w, -1.0)

    ar = jnp.arange(A, dtype=jnp.int32)[None, :]

    score = win_w
    d0s, qlos, qhis, weights, ns, valids, dstars = [], [], [], [], [], [], []
    for _ in range(n_candidates):
        best = jnp.argmax(score, axis=1)               # (B,)
        bi = best[:, None]
        wsum = jnp.take_along_axis(score, bi, axis=1)[:, 0]
        ok = wsum > 0.0
        # member q extent + weighted-mean diagonal (masked, O(A) per cand).
        # The mean is computed on WINDOW-RELATIVE diagonals (<= win) so it
        # stays exact in float32 for genome-scale absolute diagonals — a
        # global-coordinate fp32 mean drifts by hundreds of bases at
        # hundreds of Mb and pushes the window off the band.
        dstar_c = jnp.take_along_axis(ds, bi, axis=1)[:, 0]
        reld = ds - dstar_c[:, None]
        member = (reld >= 0) & (reld < win) & valid
        nmem = jnp.sum(member, axis=1).astype(jnp.int32)
        rel = jnp.where(member, ws * reld.astype(jnp.float32), 0.0).sum(axis=1)
        d0 = jnp.where(
            ok,
            dstar_c + (rel / jnp.maximum(wsum, 1e-9)).astype(jnp.int32),
            0,
        )
        qlo = jnp.min(jnp.where(member, qs, BIG), axis=1)
        qhi = jnp.max(jnp.where(member, qs + k, -1), axis=1)
        d0s.append(d0)
        qlos.append(jnp.where(ok, qlo, 0))
        qhis.append(jnp.where(ok, qhi, 0))
        weights.append(jnp.where(ok, wsum, 0.0))
        ns.append(jnp.where(ok, nmem, 0))
        valids.append(ok)
        dstars.append(jnp.where(ok, dstar_c, 0))
        # suppress anchors within +-win of the chosen window start
        near = (ds >= dstar_c[:, None] - win) & (ds < dstar_c[:, None] + win)
        score = jnp.where(near, -1.0, score)

    stack = lambda xs: jnp.stack(xs, axis=1)
    return Candidates(
        d0=stack(d0s),
        q_lo=stack(qlos),
        q_hi=stack(qhis),
        weight=stack(weights),
        n_anchors=stack(ns),
        valid=stack(valids),
        dstar=stack(dstars),
    )


@functools.partial(jax.jit, static_argnames=("k", "win"))
def chain_stats(
    t: jax.Array,        # (B, A) int32 anchor genome pos
    q: jax.Array,        # (B, A) int32 anchor read pos
    valid: jax.Array,    # (B, A) bool
    dstar: jax.Array,    # (B, C) int32 window-start diagonal per candidate
    cvalid: jax.Array,   # (B, C) bool candidate validity
    *,
    k: int,              # anchor k-mer length
    win: int,            # diagonal window width (same as select_candidates)
) -> tuple[jax.Array, jax.Array, jax.Array, tuple]:
    """Colinear-chain evidence per candidate window — the GlobalChain /
    LIS-p-value role (reference GlobalChain.h:100 max-weight colinear chain
    inside each stored interval; ComputeLISPValue, LISPValue.h:86-172,
    whose log-p is ``pFirst + (n_chain-1) * log(1/G)`` so interval RANK is
    chain count and the ``maxPValue = log(0.5)`` gate at Blasr.cpp:2373
    rejects windows whose evidence is a bare k-mer hit).

    Returns ``(n_chain, chained_any, mass)`` each (B, C):
      n_chain      int32 1 + count of member anchors with a colinear,
                   non-overlapping predecessor (q_prev <= q - k AND
                   t_prev <= t - k within the window). An overcount of the
                   greedy chain by a roughly uniform factor — monotone in
                   the true chain size, which is all p-value RANKING needs.
      chained_any  bool: the maxPValue insert gate — a >=2-anchor colinear
                   chain exists (exact pair test), OR the window carries a
                   single maximal exact match long enough to clear the
                   gate on its own. The reference always has a count table
                   (built in memory when no .ctab file exists,
                   Blasr.cpp:4482), so ComputeLISPValue's lis.size()==1
                   branch (LISPValue.h:104) scores a lone match via PMatch
                   (ScoreAnchors.h:23): p = 1 + (len-k-1)*log(trans), and
                   with uniform-composition transitions (~1/4) a match of
                   length >= k+3 clears log(0.5). Overlapping same-diagonal
                   anchors with query gap g <= k-1 compose into one exact
                   match of length k+g, so the test is: exists a same-
                   diagonal member pair with 3 <= q_j - q_i <= k-1.
      mass         int32 non-overlapping anchor base coverage of the
                   window's members: the union length of their [q, q+k)
                   read intervals. Role of noOvpLisNBases at the interval
                   insertion gate ``noOvpLisNBases > params.minInterval``
                   (FindMaxInterval.h:832) with this fork's default
                   minInterval = 100 (MappingParameters.h:348) — the gate
                   that keeps bare-match windows (one 17-30 bp exact hit
                   inside a repeat family) out of the interval queue, which
                   is why the reference never emits the weak secondary
                   records a free local DP can stitch out of such windows.

    Fully vectorized AND order-free: every "previous/next member" quantity
    is a pairwise masked reduce over the anchor axis — no argsort, no
    associative scan, no minor-dim take_along_axis. The pairwise masks
    fuse into their reductions, so nothing (B, C, A, A)-shaped is
    materialized.
    """
    B, A = t.shape
    BIG = jnp.int32(2**30)
    d = t - q

    # window membership per candidate: (B, C, A)
    reld = d[:, None, :] - dstar[:, :, None]
    mem = valid[:, None, :] & (reld >= 0) & (reld < win) & cvalid[:, :, None]

    # colinear non-overlapping predecessor (GlobalChain link test):
    # min t over members i with q_i <= q_j - k must be <= t_j - k.
    # Pairwise (B, C, Aj, Ai) masked min, reduced over Ai.
    q_i = q[:, None, None, :]                                # (B,1,1,Ai)
    q_j = q[:, None, :, None]                                # (B,1,Aj,1)
    mem_i = mem[:, :, None, :]                               # (B,C,1,Ai)
    prev_mask = mem_i & (q_i <= q_j - k)
    prev_t = jnp.min(
        jnp.where(prev_mask, t[:, None, None, :], BIG), axis=-1
    )                                                        # (B, C, Aj)
    has_prev = prev_t <= t[:, None, :] - k
    chained = mem & has_prev
    n_link = jnp.sum(chained, axis=-1).astype(jnp.int32)
    any_mem = jnp.any(mem, axis=-1)

    # single-maximal-match admission (PMatch role, see docstring): anchor j
    # composes with an overlapping same-diagonal predecessor i into an
    # exact match of length k + (q_j - q_i); length >= k+3 clears the gate.
    # The partner shares the diagonal, so j's window membership implies i's.
    gap = q[:, :, None] - q[:, None, :]                      # (B, Aj, Ai)
    pair_ok = jnp.any(
        (d[:, :, None] == d[:, None, :])
        & valid[:, :, None] & valid[:, None, :]
        & (gap >= 3) & (gap <= k - 1),
        axis=-1,
    )                                                        # (B, A)
    single_ok = jnp.any(mem & pair_ok[:, None, :], axis=-1)

    # ---- chain corners (WeightedInterval qStart/qEnd/tStart/tEnd role):
    # span of members PARTICIPATING in the colinear chain — having a
    # non-overlapping colinear predecessor or successor. The symmetric
    # successor test mirrors has_prev: max t over members with
    # q >= q_j + k must be >= t_j + k.
    succ_mask = mem_i & (q_i >= q_j + k)
    succ_t = jnp.max(
        jnp.where(succ_mask, t[:, None, None, :], -BIG), axis=-1
    )
    has_succ = succ_t >= t[:, None, :] + k
    part = mem & (has_prev | has_succ)
    # fall back to all members when no pair chains (single-match windows)
    use = jnp.where(jnp.any(part, axis=-1, keepdims=True), part, mem)
    qpart = jnp.broadcast_to(q[:, None, :], mem.shape)
    tpart = jnp.broadcast_to(t[:, None, :], mem.shape)
    q_lo_ch = jnp.min(jnp.where(use, qpart, BIG), axis=-1)
    q_hi_ch = jnp.max(jnp.where(use, qpart + k, -BIG), axis=-1)
    t_lo_ch = jnp.min(jnp.where(use, tpart, BIG), axis=-1)
    t_hi_ch = jnp.max(jnp.where(use, tpart + k, -BIG), axis=-1)
    corners = (
        jnp.where(any_mem, q_lo_ch, 0).astype(jnp.int32),
        jnp.where(any_mem, q_hi_ch, 0).astype(jnp.int32),
        jnp.where(any_mem, t_lo_ch, 0).astype(jnp.int32),
        jnp.where(any_mem, t_hi_ch, 0).astype(jnp.int32),
    )

    # union length of member [q, q+k) intervals: each member contributes
    # min(k, next_q - q) where next_q is the smallest member q strictly
    # after it in (q, index) order — duplicates contribute 0 except the
    # canonical last, exactly like the old sorted-scan formulation
    idx_i = jnp.arange(A, dtype=jnp.int32)[None, None, None, :]
    idx_j = jnp.arange(A, dtype=jnp.int32)[None, None, :, None]
    after = (q_i > q_j) | ((q_i == q_j) & (idx_i > idx_j))
    next_q = jnp.min(
        jnp.where(mem_i & after, q_i, BIG), axis=-1
    )                                                        # (B, C, Aj)
    contrib = jnp.where(
        mem, jnp.minimum(jnp.int32(k), next_q - q[:, None, :]), 0
    )
    mass = jnp.sum(contrib, axis=-1).astype(jnp.int32)
    return (
        n_link + any_mem.astype(jnp.int32),
        jnp.any(chained, axis=-1) | single_ok,
        mass,
        corners,
    )


def anchor_weights(
    nhits: jax.Array, valid: jax.Array, genome_len: int, win: int, pval_type: int
) -> jax.Array:
    """Per-anchor evidence weight — the candidate-weightor family.

    Role of the reference's -pvaltype weightor selection
    (Blasr.cpp:2342-2347,2388-2488; LISPValueWeightor / LISSumOfLogPWeightor /
    LISSizeWeightor in common/algorithms/anchoring/):

      0/1  -log2 of the expected number of random hits of this k-mer inside
           the candidate window (nhits * win / G) — rarer k-mers carry more
           evidence, the vectorized analogue of ComputeLISPValue over the
           TupleCountTable (the SA-interval width IS the genome-wide count)
      2    plain anchor count (LISSizeWeightor)
      3    inverse frequency 1/nhits (legacy v0 weighting)
    """
    nh = jnp.maximum(nhits, 1).astype(jnp.float32)
    if pval_type == 2:
        w = jnp.ones_like(nh)
    elif pval_type == 3:
        w = 1.0 / nh
    else:
        expect = nh * jnp.float32(win) / jnp.float32(max(genome_len, 1))
        w = jnp.maximum(-jnp.log2(expect), 0.5)
    return jnp.where(valid, w, 0.0)


def global_chain_exact(
    q: "np.ndarray", t: "np.ndarray", l: "np.ndarray"
) -> tuple[int, list[int]]:
    """Exact max-weight colinear chain — reference GlobalChain semantics
    (GlobalChain.h:100-210): fragment weight = its length; fragment i may
    precede j iff i's END does not pass j's START in either coordinate
    (endpoint sweep with a priority search tree; here an O(n^2) DP, used
    as the correctness ORACLE for chain_stats' vectorized evidence count
    and for tools that need the chain itself).

    Host-side numpy (anchor lists are small); returns (best_weight,
    chain indices into the input arrays, start->end order).
    """
    import numpy as np

    n = len(q)
    if n == 0:
        return 0, []
    order = np.lexsort((t, q))
    qs, ts, ls = q[order], t[order], l[order]
    score = ls.astype(np.int64).copy()
    prev = np.full(n, -1, np.int64)
    for j in range(n):
        ok = (qs[:j] + ls[:j] <= qs[j]) & (ts[:j] + ls[:j] <= ts[j])
        if ok.any():
            cand = np.where(ok, score[:j], -1)
            i = int(cand.argmax())
            if cand[i] > 0:
                score[j] = ls[j] + cand[i]
                prev[j] = i
    jbest = int(score.argmax())
    chain = []
    while jbest >= 0:
        chain.append(int(order[jbest]))
        jbest = int(prev[jbest])
    chain.reverse()
    return int(score.max()), chain


@functools.partial(jax.jit, static_argnames=("k", "win"))
def chain_weight_device(
    t: jax.Array,        # (B, A) int32 anchor genome pos
    q: jax.Array,        # (B, A) int32 anchor read pos
    valid: jax.Array,    # (B, A) bool
    dstar: jax.Array,    # (B, C) int32 window-start diagonal per candidate
    cvalid: jax.Array,   # (B, C) bool
    *,
    k: int,
    win: int,
) -> jax.Array:          # (B, C) int32 exact max-weight chain per window
    """EXACT max-weight colinear chain per candidate window, on device —
    the reference GlobalChain ranking (GlobalChain.h:100-210: fragment
    weight = its length, predecessor = END passes neither START
    coordinate; fixed-k anchors make the weight k * chain size). Equals
    ``global_chain_exact`` restricted to each window's members
    (tests/test_chain.py oracle check).

    Mechanism: anchors process in strict q-order (a valid predecessor has
    q_i + k <= q_j, so every predecessor precedes its successor) via a
    fori_loop over q-ranks computed pairwise (no sort); each step is a
    masked max over the window members' already-final chain weights. Cost
    ~2-3 ms/batch at bench shapes — the serving default stays the
    chain-evidence count (params.exact_chain selects this ranking)."""
    B, A = t.shape
    d = t - q
    reld = d[:, None, :] - dstar[:, :, None]
    mem = valid[:, None, :] & (reld >= 0) & (reld < win) & cvalid[:, :, None]
    idx = jnp.arange(A, dtype=jnp.int32)
    q_i = q[:, None, :]
    q_j = q[:, :, None]
    before = (q_i < q_j) | (
        (q_i == q_j) & (idx[None, None, :] < idx[None, :, None])
    )
    rank = jnp.sum(before, axis=-1).astype(jnp.int32)      # (B, A) permutation
    C = dstar.shape[1]
    f0 = jnp.zeros((B, C, A), jnp.int32)

    def body(s, f):
        act = rank == s                                    # (B, A) one-hot
        qj_s = jnp.sum(jnp.where(act, q, 0), axis=-1)      # (B,)
        tj_s = jnp.sum(jnp.where(act, t, 0), axis=-1)
        pred = (
            mem
            & (q[:, None, :] + k <= qj_s[:, None, None])
            & (t[:, None, :] + k <= tj_s[:, None, None])
        )
        pm = jnp.max(jnp.where(pred, f, 0), axis=-1)       # (B, C)
        mem_act = jnp.any(mem & act[:, None, :], axis=-1)  # (B, C)
        fj = jnp.where(mem_act, k + pm, 0)
        return jnp.where(act[:, None, :], fj[:, :, None], f)

    f = jax.lax.fori_loop(0, A, body, f0)
    return jnp.max(f, axis=-1)
