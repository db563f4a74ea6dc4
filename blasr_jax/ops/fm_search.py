"""Batched FM-index backward search on device (L3 alternative path).

Role of reference ``common/algorithms/anchoring/BWTSearch.h`` (:9-92
``MapReadToGenome`` over the FM-index: per read position backward-search the
suffix, cap hits, ``Locate`` each) re-designed for batched devices:

  * rank/occ = one row gather from the (NB, 128) BWT + compare + masked sum
    — a rank query is a handful of vector ops (no popcount tables needed)
  * backward search runs k fixed steps vectorized over every (read, position)
    query at once
  * locate = LF-walk of at most SAMPLE_D-1 steps (sampled-SA stride), all
    lanes in lockstep with popcount-rank into the bit-packed sample mask

The output contract matches ops/anchors.find_anchors so the rest of the
mapping pipeline is index-agnostic.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from blasr_jax.index.fm import ROW, SAMPLE_D, SENTINEL


def build_bit_masks(bwt_rows) -> "np.ndarray":
    """(NB, 6, ROW/32) uint32: bit j of word w for char c set iff
    bwt_rows[b, 32w + j] == c. Built host-side at index upload; lets
    fm_occ answer a rank query with 4 word gathers + popcount instead of
    a 128-element row gather."""
    import numpy as np

    NB, R = bwt_rows.shape
    assert R == ROW and ROW % 32 == 0
    bits = bwt_rows[:, None, :] == np.arange(
        6, dtype=bwt_rows.dtype)[None, :, None]           # (NB, 6, ROW)
    w = bits.reshape(NB, 6, ROW // 32, 32)
    return (
        w.astype(np.uint32) << np.arange(32, dtype=np.uint32)
    ).sum(axis=-1, dtype=np.uint32)


def fm_occ(
    bwt_rows: jax.Array, occ_bins: jax.Array, c: jax.Array, i: jax.Array,
    masks: jax.Array | None = None,
):
    """occ(c, i) = # of char c in bwt[0:i), vectorized over queries.

    c, i: any matching shape; returns same shape int32. i may equal n
    (interval end): when n is a multiple of ROW that lands one row past
    the table, so the row index clamps and the residual covers the whole
    final row (its padding value 6 never matches a real char).

    With ``masks`` (build_bit_masks) the within-row rank is 4 word
    gathers + population_count; without, the row-slice gather. The
    pipeline does not pass masks; which form is faster on the GPU is not
    measured (tests/test_fm.py checks the two are bit-equal).
    """
    NB = bwt_rows.shape[0]
    b = i // ROW
    r = i % ROW
    bc = jnp.minimum(b, NB - 1)
    r = r + (b - bc) * ROW                               # ROW when clamped
    if masks is not None:
        NW = ROW // 32
        mflat = masks.reshape(-1)
        base = (bc * 6 + c) * NW
        acc = jnp.zeros(jnp.broadcast_shapes(c.shape, r.shape), jnp.int32)
        for w in range(NW):
            word = mflat[base + w]
            rem = jnp.clip(r - 32 * w, 0, 32)
            lowmask = jnp.where(
                rem >= 32,
                jnp.uint32(0xFFFFFFFF),
                (jnp.uint32(1) << rem.astype(jnp.uint32)) - jnp.uint32(1),
            )
            acc = acc + jax.lax.population_count(
                word & lowmask
            ).astype(jnp.int32)
        return occ_bins[bc, c] + acc
    rows = bwt_rows[bc]                                  # (..., ROW)
    lane = jnp.arange(ROW, dtype=jnp.int32)
    within = jnp.sum(
        (rows == c[..., None]) & (lane < r[..., None]), axis=-1, dtype=jnp.int32
    )
    return occ_bins[bc, c] + within


def fm_count_kmers(
    bwt_rows: jax.Array,   # (NB, ROW) uint8
    occ_bins: jax.Array,   # (NB, 6) int32
    C: jax.Array,          # (7,) int64/int32
    codes: jax.Array,      # (B, L) uint8
    lengths: jax.Array,    # (B,) int32
    k: int,
    n: int,
    masks: "jax.Array | None" = None,
    stride: int = 1,
):
    """Backward-search the k-mer starting at every ``stride``-th read
    position (the SA path's anchor_stride twin: position i of the output
    is read position i*stride — the backward-search rank rounds, the
    dominant -bwt cost, shrink by the same factor).

    Returns (lo, hi) int32 (B, ceil(L/stride)): the BWT row interval of
    suffixes prefixed by codes[b, i*stride : +k]; empty (lo==hi) where
    the window is invalid (contains N, runs past the read end).
    """
    B, L = codes.shape
    st = max(1, stride)
    Ls = -(-L // st)
    ext = jnp.pad(codes, ((0, 0), (0, k + st)), constant_values=4)
    lo = jnp.zeros((B, Ls), jnp.int32)
    hi = jnp.full((B, Ls), n, jnp.int32)
    Ci = C.astype(jnp.int32)
    bad = jnp.zeros((B, Ls), bool)
    for j in range(k - 1, -1, -1):
        w = ext[:, j :: st][:, :Ls] if st > 1 else ext[:, j : j + L]
        c = w.astype(jnp.int32)
        bad = bad | (c >= 4)
        lo = Ci[c] + fm_occ(bwt_rows, occ_bins, c, lo, masks)
        hi = Ci[c] + fm_occ(bwt_rows, occ_bins, c, hi, masks)
    pos = jnp.arange(Ls, dtype=jnp.int32)[None, :] * st
    bad = bad | (pos + k > lengths[:, None])
    hi = jnp.where(bad, lo, hi)
    return lo, hi


def fm_locate(
    bwt_rows: jax.Array,
    occ_bins: jax.Array,
    C: jax.Array,
    ssa_mask: jax.Array,   # (W32,) uint32
    ssa_base: jax.Array,   # (W32,) int32
    ssa_vals: jax.Array,   # (n_sampled,) int
    rows: jax.Array,       # (...,) int32 BWT rows to locate
    masks: "jax.Array | None" = None,
) -> jax.Array:
    """Text position of each row (vectorized LF-walk, <= SAMPLE_D-1 steps)."""
    Ci = C.astype(jnp.int32)
    pos = jnp.zeros(rows.shape, jnp.int32)
    done = jnp.zeros(rows.shape, bool)
    cur = rows.astype(jnp.int32)
    steps = jnp.zeros(rows.shape, jnp.int32)
    for _ in range(SAMPLE_D):
        w = cur // 32
        b = cur % 32
        bit = (ssa_mask[w] >> b.astype(jnp.uint32)) & 1
        hit = (bit == 1) & ~done
        mask_below = ssa_mask[w] & ((jnp.uint32(1) << b.astype(jnp.uint32)) - 1)
        rank = ssa_base[w] + jax.lax.population_count(mask_below).astype(jnp.int32)
        val = ssa_vals[jnp.clip(rank, 0, ssa_vals.shape[0] - 1)].astype(jnp.int32)
        pos = jnp.where(hit, val + steps, pos)
        done = done | hit
        # LF step for lanes still walking
        c = bwt_rows[cur // ROW, cur % ROW].astype(jnp.int32)
        is_dollar = c >= SENTINEL
        nxt = jnp.where(
            is_dollar,
            jnp.int32(0),
            Ci[jnp.clip(c, 0, 5)]
            + fm_occ(bwt_rows, occ_bins, jnp.clip(c, 0, 5), cur, masks),
        )
        cur = jnp.where(done, cur, nxt)
        steps = steps + (~done).astype(jnp.int32)
    return pos


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "n", "max_hits_per_pos", "max_anchors_per_read", "anchor_stride"
    ),
)
def find_anchors_fm(
    codes: jax.Array,        # (B, L) uint8
    lengths: jax.Array,      # (B,) int32
    bwt_rows: jax.Array,
    occ_bins: jax.Array,
    C: jax.Array,
    ssa_mask: jax.Array,
    ssa_base: jax.Array,
    ssa_vals: jax.Array,
    pos_ok: jax.Array,       # (G,) bool anchor-seed validity (contig bounds)
    *,
    k: int,
    n: int,
    max_hits_per_pos: int = 8,
    max_anchors_per_read: int = 512,
    masks: "jax.Array | None" = None,  # build_bit_masks: popcount rank
    anchor_stride: int = 1,
):
    """FM-index anchor search with the find_anchors output contract:
    (t, q, nhits, valid) each (B, A)."""
    B, L = codes.shape
    KH = max_hits_per_pos
    A = max_anchors_per_read
    G = n - 1

    ST = max(1, anchor_stride)
    lo, hi = fm_count_kmers(
        bwt_rows, occ_bins, C, codes, lengths, k, n, masks, stride=ST
    )
    Ls = lo.shape[1]                       # strided positions per read
    nh = (hi - lo).astype(jnp.int32)
    pos_has = (nh > 0) & (nh <= KH)

    offs = jnp.arange(KH, dtype=jnp.int32)
    rows = jnp.clip(lo[..., None] + offs[None, None, :], 0, n - 1)  # (B,Ls,KH)
    hit_ok = pos_has[..., None] & (offs[None, None, :] < nh[..., None])
    t = fm_locate(
        bwt_rows, occ_bins, C, ssa_mask, ssa_base, ssa_vals, rows, masks
    )
    t = jnp.clip(t, 0, G - 1)
    hit_ok = hit_ok & pos_ok[t]

    # read position of strided slot i is i*ST; the spread bonus runs in
    # SLOT space, exactly like ops/anchors' priority
    q = jnp.broadcast_to(
        jnp.arange(Ls, dtype=jnp.int32)[None, :, None] * ST, (B, Ls, KH)
    )
    stride = max(1, (2 * Ls * KH) // max(A, 1) // 2)
    base = jnp.int32(1 << 20)
    prio = base - nh[..., None] * 16
    slot = jnp.arange(Ls, dtype=jnp.int32)[None, :, None]
    prio = prio + jnp.where(slot % stride == 0, base // 2, 0)
    prio = jnp.where(hit_ok, prio, jnp.int32(-1))

    flat_prio = prio.reshape(B, Ls * KH)
    vals, sel = jax.lax.top_k(flat_prio, A)
    at = jnp.take_along_axis(t.reshape(B, Ls * KH), sel, axis=1)
    aq = jnp.take_along_axis(q.reshape(B, Ls * KH), sel, axis=1)
    anh = jnp.take_along_axis(
        jnp.broadcast_to(nh[..., None], (B, Ls, KH)).reshape(B, Ls * KH),
        sel, axis=1,
    )
    avalid = vals > 0
    return at, aq, jnp.maximum(anh, 1), avalid
