"""Batched anchor search on device (L3).

Role of reference ``common/algorithms/anchoring/MapBySuffixArray.h``
(:25-212 LocateAnchorBoundsInSuffixArray + :215-310 MapReadToGenome): for
every read position find the suffix-array interval of genome positions whose
suffix starts with the read's k-mer, then expand intervals into anchors.

Device re-design: because the index stores the packed k-mer key of every suffix
in SA order (an ascending int32 array, see index/artifacts.py), the
per-position search collapses to two vectorized binary searches
(``jnp.searchsorted``) over that array — no character-by-character LCP
walk, no divergent control flow. Interval width doubles as the genome-wide
k-mer frequency (the reference's TupleCountTable role) for anchor weighting.

Anchor compaction uses a single ``lax.top_k`` with a priority that prefers
low-frequency (unique) anchors and guarantees coverage across the read via a
stride bonus, replacing the reference's maxAnchorsPerPosition/advance
heuristics with a fixed-shape selection.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def pack_query_kmers(
    codes: jax.Array, lengths: jax.Array, k: int, stride: int = 1
) -> jax.Array:
    """Pack the k-mer starting at every ``stride``-th read position.

    codes: (B, L) uint8 with values 0..4 (4 = N/pad)
    lengths: (B,) int32
    Returns (B, ceil(L/stride)) int32 keys for positions 0, stride, 2*stride
    ...; -1 where the window is invalid (contains N or runs past the read
    end), which makes searchsorted return an empty interval. stride > 1
    computes only the needed keys (k static STRIDED slices over (B, L/ST)
    instead of k dynamic slices over (B, L)) — identical values to
    ``pack_query_kmers(..., 1)[:, ::stride]``.
    """
    B, L = codes.shape
    st = max(1, stride)
    Ls = -(-L // st)
    ext = jnp.pad(
        codes.astype(jnp.int32), ((0, 0), (0, k + st)), constant_values=4
    )
    acc = jnp.zeros((B, Ls), jnp.int32)
    bad = jnp.zeros((B, Ls), bool)
    for j in range(k):
        w = ext[:, j :: st][:, :Ls] if st > 1 else ext[:, j : j + L]
        acc = (acc << 2) | (w & 3)
        bad = bad | (w >= 4)
    pos = jnp.arange(Ls, dtype=jnp.int32)[None, :] * st
    bad = bad | (pos + k > lengths[:, None])
    return jnp.where(bad, jnp.int32(-1), acc)


def _bounded_search(
    arr: jax.Array, keys: jax.Array, lo0: jax.Array, hi0: jax.Array, steps: int
) -> jax.Array:
    """side='left' binary search of keys within per-query ranges [lo0, hi0).

    The LUT jump-start (reference SuffixArray.h prefix lookup table role)
    shrinks ranges to single prefix buckets, so ``steps`` (static, from the
    largest bucket) replaces the full log2(G) bisection.
    """
    lo, hi = lo0, hi0
    G = arr.shape[0]
    for _ in range(steps):
        mid = (lo + hi) >> 1
        v = arr[jnp.clip(mid, 0, G - 1)]
        go_right = v < keys
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    return lo




def _expand_and_select(
    sa: jax.Array, lo: jax.Array, nh: jax.Array, has_key: jax.Array,
    B: int, L: int, KH: int, A: int, ST: int,
):
    """Shared hit expansion + priority compaction for the SA-backed anchor
    searches (narrow and wide keys): prefer unique anchors, guarantee
    read-wide spread via a stride bonus, keep the top A per read.

    Hit expansion happens ONLY for the top-A positions by priority: the
    priority is position-only (frequency + spread), ties in the final
    flat top-k break by (position, hit-offset) order, so the winning A
    anchors always come from the first A positions in (priority, position)
    order — pre-selecting positions provably returns the identical anchor
    set while gathering P*KH instead of L*KH random SA entries (the anchor
    phase is HBM-gather-bound)."""
    G = sa.shape[0]
    pos_has = has_key & (nh > 0) & (nh <= KH)

    stride = max(1, (2 * L * KH) // max(A, 1) // 2)
    base = jnp.int32(1 << 20)
    pos_ar = jnp.arange(L, dtype=jnp.int32)
    pos_prio = base - nh * 16 + jnp.where((pos_ar % stride) == 0, base // 2, 0)
    pos_prio = jnp.where(pos_has, pos_prio, jnp.int32(-1))    # (B, L)

    P = min(A, L)
    pvals, psel = jax.lax.top_k(pos_prio, P)                  # (B, P)
    lo_sel = jnp.take_along_axis(lo.astype(jnp.int32), psel, axis=1)
    nh_sel = jnp.take_along_axis(nh, psel, axis=1)

    # per-element flat gathers (one index per SA entry) rather than a
    # slice_sizes=(KH,) lax.gather
    offs = jnp.arange(KH, dtype=jnp.int32)
    idx = jnp.clip(lo_sel[..., None] + offs[None, None, :], 0, G - 1)
    t = sa[idx].astype(jnp.int32)                             # (B, P, KH)
    hit_ok = (pvals > 0)[..., None] & (offs[None, None, :] < nh_sel[..., None]) & (t >= 0)
    t = jnp.clip(t, 0, G - 1)

    q = jnp.broadcast_to((psel * ST)[..., None], (B, P, KH))
    prio = jnp.where(hit_ok, pvals[..., None], jnp.int32(-1))

    flat_prio = prio.reshape(B, P * KH)
    vals, sel = jax.lax.top_k(flat_prio, A)
    at = jnp.take_along_axis(t.reshape(B, P * KH), sel, axis=1)
    aq = jnp.take_along_axis(q.reshape(B, P * KH), sel, axis=1)
    anh = jnp.take_along_axis(
        jnp.broadcast_to(nh_sel[..., None], (B, P, KH)).reshape(B, P * KH),
        sel, axis=1,
    )
    avalid = vals > 0
    return at, aq, jnp.maximum(anh, 1), avalid


def _expand_select_compact(
    sa_valid: jax.Array, lut_valid: jax.Array,
    qk_lo_key: jax.Array, qk_hi_key: jax.Array,
    nh: jax.Array, has_key: jax.Array,
    B: int, L: int, KH: int, A: int, ST: int,
    nh_valid: jax.Array | None = None,  # (B, L) valid-hit counts per position.
                             # Dual role: (a) positions whose hits are ALL
                             # masked (pos_ok false / non-owned shard range)
                             # must not occupy top-P priority slots — they
                             # would crowd out anchor-bearing positions when
                             # L > A; (b) the value is EXACT for every
                             # surviving position (count <= KH < clip bound,
                             # and exact by construction on the lut_valid
                             # subtraction path), so the slot width comes
                             # from a cheap take_along_axis instead of a
                             # second big-table gather. Requires expand == 0
                             # (i.e. qk_lo_key == qk_hi_key) when clipped.
):
    """Slot-exact hit expansion over the seed-valid compacted SA.

    Equivalent to _expand_and_select (same priority, same anchor order) but
    with the masked-hit top_k replaced by direct slot assignment: every hit
    interval in ``sa_valid`` contains only valid genome positions, so the
    winning A anchors are the first A hits in (priority, position, hit)
    order — one cumsum + one scatter + one (B, A) gather instead of a
    (B, P*KH) gather + top_k. Exactness argument: all hits of a
    higher-priority position precede any hit of a lower one in both
    schemes, ties break by position-rank then hit offset in both.
    """
    Gv = sa_valid.shape[0]
    NK = lut_valid.shape[0]
    pos_has = has_key & (nh > 0) & (nh <= KH)
    if nh_valid is not None:
        pos_has = pos_has & (nh_valid > 0)

    stride = max(1, (2 * L * KH) // max(A, 1) // 2)
    base = jnp.int32(1 << 20)
    pos_ar = jnp.arange(L, dtype=jnp.int32)
    pos_prio = base - nh * 16 + jnp.where((pos_ar % stride) == 0, base // 2, 0)
    pos_prio = jnp.where(pos_has, pos_prio, jnp.int32(-1))    # (B, L)

    P = min(A, L)
    if (
        nh_valid is not None
        and L <= 512
        and KH <= 31
        and P * KH < (1 << 13)
    ):
        # pairwise slot-owner formulation: replaces top_k + scatter +
        # minor-dim take_along_axis chains with masked reduces that fuse.
        # Only worth it while the (B, L, L) rank reduce stays small;
        # long-read buckets (L > 512 strided positions) keep the top_k
        # path below. Which branch is faster on the GPU is not measured.
        return _expand_select_pairwise(
            sa_valid, lut_valid, qk_lo_key, pos_prio, nh, nh_valid,
            B, L, KH, A, ST, P,
        )
    pvals, psel = jax.lax.top_k(pos_prio, P)                  # (B, P)
    klo_sel = jnp.take_along_axis(qk_lo_key, psel, axis=1)
    lov = lut_valid[jnp.clip(klo_sel, 0, NK - 2)]
    if nh_valid is not None:
        # valid counts were already gathered per position — reuse them via a
        # local take instead of a second big-table gather (exactness: see
        # the parameter note above)
        cntv = jnp.take_along_axis(nh_valid, psel, axis=1)
    else:
        khi_sel = jnp.take_along_axis(qk_hi_key, psel, axis=1)
        hiv = lut_valid[jnp.clip(khi_sel + 1, 0, NK - 1)]
        cntv = jnp.maximum(hiv - lov, 0)
    cnt = jnp.where(pvals > 0, cntv, 0)                       # valid hits

    # nh is exact for every position that can pass the <= KH filter (the
    # clipped uint8 view only saturates above 255 > KH), so the reported
    # genome-wide frequency needs no further table gather
    nh_sel = jnp.take_along_axis(nh, psel, axis=1)

    csum = jnp.cumsum(cnt, axis=1)
    starts = csum - cnt                                       # exclusive
    total = csum[:, -1:]                                      # (B, 1)

    # slot s belongs to the last position whose start <= s and cnt > 0:
    # scatter a mark at every position's start slot, prefix-sum over slots
    rows = jnp.arange(B, dtype=jnp.int32)[:, None]
    mark = jnp.zeros((B, A + 1), jnp.int32).at[
        rows, jnp.clip(starts, 0, A)
    ].add(1)
    prank = jnp.clip(jnp.cumsum(mark[:, :A], axis=1) - 1, 0, P - 1)  # (B, A)

    sar = jnp.arange(A, dtype=jnp.int32)[None, :]
    if KH <= 31 and L <= (1 << 12) and A <= (1 << 13):
        # one packed take instead of four: (pv>0 | nh | psel | start)
        packed = (
            ((pvals > 0).astype(jnp.int32) << 30)
            | (jnp.clip(nh_sel, 0, 31) << 25)
            | (psel << 13)
            | starts
        )
        pk = jnp.take_along_axis(packed, prank, axis=1)
        lo_at = jnp.take_along_axis(lov, prank, axis=1)
        st_at = pk & ((1 << 13) - 1)
        psel_at = (pk >> 13) & ((1 << 12) - 1)
        anh = (pk >> 25) & 31
        pv_ok = (pk >> 30) > 0
    else:
        st_at = jnp.take_along_axis(starts, prank, axis=1)
        lo_at = jnp.take_along_axis(lov, prank, axis=1)
        pv_ok = jnp.take_along_axis(pvals, prank, axis=1) > 0
        psel_at = jnp.take_along_axis(psel, prank, axis=1)
        anh = jnp.take_along_axis(nh_sel, prank, axis=1)

    within = sar - st_at
    at = sa_valid[jnp.clip(lo_at + within, 0, Gv - 1)].astype(jnp.int32)
    aq = psel_at * ST
    avalid = (sar < total) & pv_ok
    return jnp.clip(at, 0, None), aq, jnp.maximum(anh, 1), avalid


def _expand_select_pairwise(
    sa_valid: jax.Array, lut_valid: jax.Array,
    qk_lo_key: jax.Array, pos_prio: jax.Array,
    nh: jax.Array, nh_valid: jax.Array,
    B: int, L: int, KH: int, A: int, ST: int, P: int,
):
    """_expand_select_compact's hot-bucket equivalent with the selection
    machinery expressed as pairwise masked reduces (order-free, gather-free
    until the actual table lookups):

      rank_p   = #positions strictly better in (priority desc, pos asc) —
                 exactly jax.lax.top_k's order, so selected = rank < P
                 reproduces the top-P set and tie order bit-for-bit
      starts_p = sum of selected valid-hit counts over better positions
                 (the exclusive rank-order cumsum, without sorting)
      owner(s) = the occupied position with the largest starts <= s —
                 one packed masked max over (B, A, L); its start / read
                 pos / frequency unpack from the packed key, and a second
                 equality-masked max recovers the owner's k-mer key for
                 the lut_valid lookup.

    Caller guarantees: KH <= 31, L <= 4096, P*KH < 8192 (packing bounds).
    """
    Gv = sa_valid.shape[0]
    NK = lut_valid.shape[0]
    pos_ar = jnp.arange(L, dtype=jnp.int32)
    prio_i = pos_prio[:, None, :]                            # (B, 1, Lp')
    prio_j = pos_prio[:, :, None]                            # (B, Lp, 1)
    better = (prio_i > prio_j) | (
        (prio_i == prio_j) & (pos_ar[None, None, :] < pos_ar[None, :, None])
    )
    rank = jnp.sum(better, axis=-1).astype(jnp.int32)        # (B, L)
    sel = (pos_prio > 0) & (rank < P)
    cnt = jnp.where(sel, nh_valid, 0)
    starts = jnp.sum(
        jnp.where(better, cnt[:, None, :], 0), axis=-1
    ).astype(jnp.int32)                                      # (B, L)
    total = jnp.sum(cnt, axis=-1, keepdims=True)             # (B, 1)

    occ = sel & (cnt > 0)
    key = (
        (starts << 17) | (pos_ar[None, :] << 5) | jnp.clip(nh, 0, 31)
    )
    sar = jnp.arange(A, dtype=jnp.int32)[None, :]
    own_mask = occ[:, None, :] & (starts[:, None, :] <= sar[:, :, None])
    pk = jnp.max(
        jnp.where(own_mask, key[:, None, :], jnp.int32(-1)), axis=-1
    )                                                        # (B, A)
    owner_ok = pk >= 0
    st_at = pk >> 17
    psel_at = (pk >> 5) & 4095
    anh = pk & 31
    # owner's k-mer key (for the lut_valid base lookup): equality-masked
    # max — starts are strictly increasing over occupied positions, so the
    # owner is unique
    eq_mask = occ[:, None, :] & (starts[:, None, :] == st_at[:, :, None])
    qko_at = jnp.max(
        jnp.where(eq_mask, qk_lo_key[:, None, :], jnp.int32(-1)), axis=-1
    )
    lo_at = lut_valid[jnp.clip(qko_at, 0, NK - 2)]

    within = sar - st_at
    at = sa_valid[jnp.clip(lo_at + within, 0, Gv - 1)].astype(jnp.int32)
    aq = psel_at * ST
    avalid = (sar < total) & owner_ok
    return jnp.clip(at, 0, None), aq, jnp.maximum(anh, 1), avalid


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "max_hits_per_pos", "max_anchors_per_read", "lut_meta",
        "anchor_stride", "expand",
    ),
)
def find_anchors(
    codes: jax.Array,        # (B, L) uint8
    lengths: jax.Array,      # (B,) int32
    sa: jax.Array,           # (G,) int32 suffix array; a negative value marks
                             # a position whose seed window is invalid (the
                             # pos_ok mask pre-folded at index build)
    sa_kmers: jax.Array,     # (G,) int32 ascending packed k-mers in SA order
    pos_ok: jax.Array | None = None,  # (G,) bool, or None if folded into sa
    lut: jax.Array | None = None,  # (2^bits + 1,) int32 prefix ranges
    run_len: jax.Array | None = None,  # (G,) int32: #identical keys from i on
    lut_valid: jax.Array | None = None,  # (4^k + 1,) int32 valid-only counts;
                             # when given, ``sa`` is the seed-valid compacted
                             # SA and expansion is slot-exact
    ctab16: jax.Array | None = None,  # (4^k,) uint16 combined clipped counts:
                             # (min(total,255) << 8) | min(valid,255). The hot
                             # per-position lookup is ONE gather on a table
                             # 2x smaller than lut serving both the frequency
                             # filter and the valid-slot widths
    *,
    k: int,
    max_hits_per_pos: int = 8,
    max_anchors_per_read: int = 512,
    lut_meta: tuple[int, int] | None = None,  # (shift, max_steps)
    anchor_stride: int = 1,
    expand: int = 0,   # sensitivity level: effective seed k - expand bases
                       # (reference anchorParameters.expand,
                       # MapBySuffixArray.h:176-191 backtrack; the widened
                       # interval still faces the max_hits_per_pos cap,
                       # MapBySuffixArray.h:282)
):
    """Find up to A anchors per read.

    Returns (t, q, nhits, valid):
      t      (B, A) int32  genome position of anchor start (global coords)
      q      (B, A) int32  read position of anchor start
      nhits  (B, A) int32  genome-wide frequency of the anchor k-mer
      valid  (B, A) bool
    """
    B, L = codes.shape
    G = sa.shape[0]
    KH = max_hits_per_pos
    A = max_anchors_per_read

    ST = max(1, anchor_stride)
    # anchor every ST-th read position (role of advanceExactMatches / the
    # reference's speed-sensitivity frontier, README.md:53-58); the packer
    # computes only the strided keys
    qk = pack_query_kmers(codes, lengths, k, ST)                  # (B, L/ST)
    L = qk.shape[1]
    # expand > 0 widens every lookup to the interval of the (k - expand)-base
    # prefix: keys in [qk & ~mask, qk | mask] (low 2*expand bits free)
    e2 = 2 * min(max(expand, 0), k - 1)
    mask = jnp.int32((1 << e2) - 1)
    qk_lo_key = qk & ~mask
    qk_hi_key = qk | mask
    if lut is not None and lut_meta is not None and lut_meta[1] == 0:
        if expand == 0 and ctab16 is not None and lut_valid is not None:
            # hot path: ONE uint16 gather gives min(total, 255) in the high
            # byte and min(valid, 255) in the low byte — exact for the
            # nh <= KH filter and the priority (overflowed positions are
            # filtered either way; KH < 255 asserted)
            assert KH < 255
            cv = ctab16[jnp.clip(qk, 0, ctab16.shape[0] - 1)].astype(jnp.int32)
            cv = jnp.where(qk >= 0, cv, 0)
            nh = cv >> 8
            nh_v = cv & 255
            return _expand_select_compact(
                sa, lut_valid, qk_lo_key, qk_hi_key, nh, qk >= 0,
                B, L, KH, A, ST, nh_valid=nh_v,
            )
        # full-resolution direct-address table (lut.shape == 4^k + 1):
        # lo and the interval width come from two gathers, no bisection
        key = jnp.clip(qk_lo_key, 0, lut.shape[0] - 2)
        lo = lut[key]
        key_hi = jnp.clip(qk_hi_key + 1, 0, lut.shape[0] - 1)
        nh = jnp.where(qk >= 0, lut[key_hi] - lo, 0).astype(jnp.int32)
        if lut_valid is not None:
            lo_v = lut_valid[jnp.clip(qk_lo_key, 0, lut_valid.shape[0] - 2)]
            hi_v = lut_valid[jnp.clip(qk_hi_key + 1, 0, lut_valid.shape[0] - 1)]
            nh_v = jnp.where(qk >= 0, hi_v - lo_v, 0).astype(jnp.int32)
            return _expand_select_compact(
                sa, lut_valid, qk_lo_key, qk_hi_key, nh, qk >= 0,
                B, L, KH, A, ST, nh_valid=nh_v,
            )
    elif lut is not None and lut_meta is not None:
        shift, max_steps = lut_meta
        steps = max_steps + max(0, e2 - shift)  # widened range spans buckets
        pref_lo = jnp.clip(qk_lo_key >> shift, 0, lut.shape[0] - 2)
        pref_hi = jnp.clip(qk_hi_key >> shift, 0, lut.shape[0] - 2)
        blo = lut[pref_lo]
        bhi = lut[pref_hi + 1]
        lo = _bounded_search(sa_kmers, qk_lo_key, blo, bhi, steps)
        if expand == 0 and run_len is not None:
            # interval width without a second search: lo is side='left', so
            # when the key is present sa_kmers[lo] == key and the
            # precomputed run length IS hi - lo (halves the gather rounds
            # of the search phase)
            loc = jnp.clip(lo, 0, G - 1)
            present = (sa_kmers[loc] == qk) & (lo < G)
            nh = jnp.where(present, run_len[loc], 0).astype(jnp.int32)
        else:
            hi = _bounded_search(sa_kmers, qk_hi_key + 1, lo, bhi, steps)
            nh = (hi - lo).astype(jnp.int32)
    else:
        lo = jnp.searchsorted(
            sa_kmers, qk_lo_key, side="left", method="scan_unrolled"
        )
        hi = jnp.searchsorted(
            sa_kmers, qk_hi_key, side="right", method="scan_unrolled"
        )
        nh = (hi - lo).astype(jnp.int32)                          # (B, L)
    if pos_ok is not None:
        # legacy call shape (tests): fold the validity mask into sa here
        sa = jnp.where(pos_ok[jnp.clip(sa, 0, G - 1)] & (sa >= 0), sa, -1)
    return _expand_and_select(sa, lo, nh, qk >= 0, B, L, KH, A, ST)


def _bounded_search_wide(
    hi_arr: jax.Array, lo_arr: jax.Array,
    khi: jax.Array, klo: jax.Array,
    lo0: jax.Array, hi0: jax.Array, steps: int,
) -> jax.Array:
    """side='left' binary search for compound keys (hi, lo) — the int64
    k-mer split into top-30-bit / bottom-bit int32 halves for large k."""
    lo, hi = lo0, hi0
    G = hi_arr.shape[0]
    for _ in range(steps):
        mid = (lo + hi) >> 1
        mc = jnp.clip(mid, 0, G - 1)
        vh = hi_arr[mc]
        vl = lo_arr[mc]
        go_right = (vh < khi) | ((vh == khi) & (vl < klo))
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    return lo


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "max_hits_per_pos", "max_anchors_per_read", "lut_meta",
        "anchor_stride", "expand",
    ),
)
def find_anchors_wide(
    codes: jax.Array,        # (B, L) uint8
    lengths: jax.Array,      # (B,) int32
    sa: jax.Array,           # (G,) int32, negative = invalid seed (folded mask)
    kmer_hi: jax.Array,      # (G,) int32: top 30 bits (first 15 bases)
    kmer_lo: jax.Array,      # (G,) int32: bottom 2(k-15) bits
    lut: jax.Array,          # prefix LUT over kmer_hi
    *,
    k: int,                  # 16..30
    max_hits_per_pos: int = 8,
    max_anchors_per_read: int = 512,
    lut_meta: tuple[int, int] | None = None,  # (shift within hi, max_steps)
    anchor_stride: int = 1,
    expand: int = 0,   # sensitivity level (see find_anchors); for wide keys
                       # the freed bits are clamped to the low key half
                       # (effective seed never drops below 15 bases)
):
    """find_anchors for k > 15 (large genomes need longer seeds for
    specificity; the reference gets this via LCP extension of unique
    matches, MapBySuffixArray.h:132-170 — here the seed itself is longer).

    Same output contract as find_anchors.
    """
    assert 16 <= k <= 30
    B, L = codes.shape
    G = sa.shape[0]
    KH = max_hits_per_pos
    A = max_anchors_per_read

    qk_hi = pack_query_kmers(codes, lengths, 15)                # (B, L)
    klo_full = pack_query_kmers(codes, lengths, k - 15)
    # low half lives k-15 bases later; out-of-range -> invalid
    qk_lo = jnp.pad(
        klo_full, ((0, 0), (0, 15)), constant_values=-1
    )[:, 15 : 15 + L]
    bad = (qk_hi < 0) | (qk_lo < 0)
    qk_hi = jnp.where(bad, jnp.int32(-1), qk_hi)
    qk_lo = jnp.where(bad, jnp.int32(0), qk_lo)

    ST = max(1, anchor_stride)
    if ST > 1:
        qk_hi = qk_hi[:, ::ST]
        qk_lo = qk_lo[:, ::ST]
        L = qk_hi.shape[1]

    shift, max_steps = lut_meta if lut_meta is not None else (0, 31)
    # expand frees the low 2*expand bits (clamped to the low key half)
    e2 = 2 * min(max(expand, 0), k - 15)
    emask = jnp.int32((1 << e2) - 1)
    qlo_l = qk_lo & ~emask
    qlo_h = qk_lo | emask
    # LUT over the HI half jump-starts the compound search; within a hi
    # bucket another log2(bucket) rounds resolve the LO half
    steps = max_steps + max(0, e2.bit_length())
    pref = jnp.clip(qk_hi >> shift, 0, lut.shape[0] - 2)
    blo = jnp.where(qk_hi >= 0, lut[pref], 0)
    bhi = jnp.where(qk_hi >= 0, lut[pref + 1], 0)
    lo = _bounded_search_wide(kmer_hi, kmer_lo, qk_hi, qlo_l, blo, bhi, steps)
    # upper key + 1 (with carry) for the right bound
    LO_MASK = (1 << (2 * (k - 15))) - 1
    carry = (qlo_h == LO_MASK).astype(jnp.int32)
    khi2 = qk_hi + carry
    klo2 = jnp.where(carry == 1, 0, qlo_h + 1)
    hi = _bounded_search_wide(kmer_hi, kmer_lo, khi2, klo2, lo, bhi, steps)

    nh = (hi - lo).astype(jnp.int32)
    return _expand_and_select(sa, lo, nh, qk_hi >= 0, B, L, KH, A, ST)
