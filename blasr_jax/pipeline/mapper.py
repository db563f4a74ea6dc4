"""Per-batch mapping step on device (L5).

Role of reference ``MapRead`` (Blasr.cpp:2246-2644) + ``AlignIntervals``
(:1152-1965): anchor -> candidate intervals -> align -> select best ->
MAPQ. Re-designed as ONE jitted program over a padded read batch:

  1. reverse-complement rows appended -> (2B, L) strand-expanded batch
  2. batched SA anchor search                      (ops/anchors.py)
  3. diagonal-window candidate selection, C/strand (ops/candidates.py)
  4. wavefront banded DP with traceback arrows over the B*CD best windows
     (ops/banded_align.py; on the GPU the kernel of ops/banded_gpu.py)
  5. on-device traceback walk over the arrows  (ops/traceback_device.py)
  6. containment filters, top-best_n selection per read, MAPQ
                                                    (ops/mapqv.py)

The host formats the records. Static shapes everywhere; one compilation
per (B, L) length bucket.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from blasr_jax.index.artifacts import GenomeIndex
from blasr_jax.ops.anchors import find_anchors, find_anchors_wide
from blasr_jax.ops.fm_search import find_anchors_fm
from blasr_jax.ops.banded_align import (
    QOFF_NUM_HALF,
    QOFF_SHIFT,
    AlignScores,
    banded_align,
    clamp_knots_to_shared,
    make_qoff_knots,
    make_qoff_num,
    qoff_from_knots,
)
from blasr_jax.ops.banded_gpu import banded_align_gpu, kernel_handles
from blasr_jax.ops.candidates import anchor_weights, chain_stats, select_candidates
from blasr_jax.ops.mapqv import map_qv_reference
from blasr_jax.ops.traceback_device import (
    pack_codes_rows,
    packed_width,
    walk_arrows_device,
)
from blasr_jax.params import MappingParams


class DeviceIndex(NamedTuple):
    """Genome index resident in device HBM.

    ``kind`` selects the anchoring engine: "sa" (suffix array + packed-kmer
    binary search, 9 B/base) or "fm" (FM-index backward search, ~1.6 B/base
    — the reference's low-memory -bwt path, README.md:70-74). ``arrays`` is
    the kind-specific tuple handed to the anchor op.
    """

    genome_pad: jax.Array   # ((G + 2*pad)/8 + 2,) int32, 8 nibble-packed
                            # codes per word (LSB first); out-of-genome = 5
    arrays: tuple           # kind-specific device arrays (see above)
    starts: jax.Array       # (C+1,) int32 contig start positions
    pad: int                # static padding amount
    k: int                  # anchor k-mer length
    genome_len: int
    kind: str = "sa"
    fm_n: int = 0           # FM total rows (G + 1) when kind == "fm"
    lut_meta: tuple | None = None  # (shift, max_steps) for the SA prefix LUT


def _pad_starts(starts: np.ndarray) -> np.ndarray:
    """Contig boundary array padded to a multiple-of-8 length with the
    total length repeated (shape-uniform across shard indexes)."""
    s = np.asarray(starts, np.int32)
    n = len(s)
    target = -(-n // 8) * 8
    if target == n:
        return s
    return np.concatenate([s, np.full(target - n, s[-1], np.int32)])


def make_device_index(
    idx: GenomeIndex, params: MappingParams, fm=None
) -> DeviceIndex:
    # cache per GenomeIndex object: repeated Mapper construction (warmup +
    # timed run, sensitive retry, per-bucket runners) must not re-upload
    # the index or rebuild the device-side prefix table
    key = (
        params.max_read_len + params.target_len,
        params.direct_lut,
        id(fm) if fm is not None else None,
    )
    cache = getattr(idx, "_device_index_cache", None)
    if cache is None:
        cache = {}
        idx._device_index_cache = cache
    hit = cache.get(key)
    # the entry pins a strong reference to the fm it was built from, so a
    # recycled id() of a garbage-collected FMIndex can never alias a live
    # entry; identity check guards the None-key case symmetry
    if hit is not None and hit[0] is fm:
        return hit[1]
    pad = params.max_read_len + params.target_len
    gp = np.full(idx.genome_length + 2 * pad, 5, dtype=np.uint8)
    gp[pad : pad + idx.genome_length] = idx.genome
    # nibble-pack 8 codes per int32 word (code values are 0..5, 4-bit safe):
    # the setup-phase target-window fetch becomes a (I, T/8) WORD gather +
    # vector unpack instead of a (I, T) per-element byte gather
    n8 = len(gp) // 8 + 2
    gp8 = np.full(n8 * 8, 5, np.uint8)
    gp8[: len(gp)] = gp
    gnib = np.zeros(n8, np.uint32)
    for j in range(8):
        gnib |= gp8[j::8].astype(np.uint32) << (4 * j)
    gp = gnib.view(np.int32)
    if fm is not None:
        arrays = (
            jnp.asarray(fm.bwt_rows),
            jnp.asarray(fm.occ_bins),
            jnp.asarray(fm.C.astype(np.int32)),
            jnp.asarray(fm.ssa_mask),
            jnp.asarray(fm.ssa_base),
            jnp.asarray(fm.ssa_vals.astype(np.int32)),
            jnp.asarray(idx.pos_ok),
        )
        kind, fm_n = "fm", fm.n
        lut_meta = None
    else:
        lut, shift, max_steps = idx.lut()
        # fold the seed-validity mask into the SA values (-1 = invalid):
        # halves the random gathers in the anchor hit expansion
        sa32 = idx.sa.astype(np.int32)
        sa_masked = np.where(idx.pos_ok[sa32], sa32, np.int32(-1))
        if 2 * idx.k > 31:
            # wide keys (k 16..30): top 30 bits / bottom bits as int32 pair
            full = idx.sa_kmers.astype(np.int64)
            lo_bits = 2 * idx.k - 30
            kmer_hi = (full >> lo_bits).astype(np.int32)
            kmer_lo = (full & ((1 << lo_bits) - 1)).astype(np.int32)
            arrays = (
                jnp.asarray(sa_masked),
                jnp.asarray(kmer_hi),
                jnp.asarray(kmer_lo),
                jnp.asarray(lut),
            )
            lut_meta = (shift, max_steps)
        else:
            direct = params.direct_lut
            if direct is None:
                # auto: the 4^k int32 table costs 4^k * 4 B HBM — worth it
                # for real genomes (kills the per-position bisection), not
                # for kb-scale test genomes
                direct = 2 * idx.k <= 28 and idx.genome_length >= (1 << 20)
            if direct and 2 * idx.k <= 28:
                # full-resolution prefix tables: lut_full[key] = first SA row
                # with kmer >= key (nh in two gathers, no bisection), plus a
                # valid-only twin over the seed-valid compacted SA so hit
                # expansion is slot-exact (ops/anchors.py
                # _expand_select_compact). All built on device
                # (scatter + cumsum) to avoid a multi-GB h2d.
                nk = 1 << (2 * idx.k)
                G = idx.genome_length
                sk_dev = jnp.asarray(idx.sa_kmers)
                sa_m_dev = jnp.asarray(sa_masked)
                valid = sa_m_dev >= 0
                counts = jnp.zeros((nk,), jnp.int32).at[sk_dev].add(1)
                lut_full = jnp.pad(jnp.cumsum(counts, dtype=jnp.int32), (1, 0))
                counts_v = jnp.zeros((nk,), jnp.int32).at[sk_dev].add(
                    valid.astype(jnp.int32)
                )
                lut_valid = jnp.pad(
                    jnp.cumsum(counts_v, dtype=jnp.int32), (1, 0)
                )
                dest = jnp.cumsum(valid.astype(jnp.int32)) - 1
                # out-of-bounds scatter indices (invalid rows -> G) drop
                sa_valid = (
                    jnp.zeros((G,), jnp.int32)
                    .at[jnp.where(valid, dest, G)]
                    .set(sa_m_dev)
                )
                # combined clipped uint16 count table (total<<8 | valid): the
                # per-position filter/priority only needs min(count, 255)
                # (any max_hits_per_pos < 255), so the hot (B, L) lookup is
                # ONE gather serving both counts — half the big-table gather
                # traffic of separate total/valid tables
                ctab16 = (
                    (jnp.minimum(counts, 255) << 8)
                    | jnp.minimum(counts_v, 255)
                ).astype(jnp.uint16)
                arrays = (sa_valid, ctab16, lut_full, lut_valid)
                lut_meta = (0, 0)  # max_steps == 0 marks the direct table
            else:
                # run-length of identical keys at every SA row: turns the
                # second (side='right') binary search into one gather
                sk = idx.sa_kmers
                change = np.flatnonzero(np.diff(sk) != 0) + 1
                bounds = np.concatenate([[0], change, [len(sk)]])
                next_bound = np.repeat(bounds[1:], np.diff(bounds))
                run_len = (next_bound - np.arange(len(sk))).astype(np.int32)
                arrays = (
                    jnp.asarray(sa_masked),
                    jnp.asarray(idx.sa_kmers),
                    jnp.asarray(lut),
                    jnp.asarray(run_len),
                )
                lut_meta = (shift, max_steps)
        kind, fm_n = "sa", 0
    di = DeviceIndex(
        genome_pad=jnp.asarray(gp),
        arrays=arrays,
        # pad the boundary array to a multiple of 8 (repeat the final
        # boundary): searchsorted(side='right')-1 lands on the true contig
        # regardless of trailing duplicates, and the UNIFORM shape means
        # shard indexes with different contig counts share one compiled
        # program (16 per-shard recompiles -> 1 on the sharded path)
        starts=jnp.asarray(_pad_starts(idx.seqdb.starts)),
        pad=pad,
        k=idx.k,
        genome_len=idx.genome_length,
        kind=kind,
        fm_n=fm_n,
        lut_meta=lut_meta,
    )
    cache[key] = (fm, di)
    return di


# row order of MapBatchResult.sel_ints
SEL_FIELDS = (
    "sel_score", "sel_t0", "sel_strand", "sel_valid", "nops",
    "q_start", "q_end", "t_start", "t_end",
    "n_match", "n_mismatch", "n_ins", "n_del", "mapqv", "sel_cd",
)


class MapBatchResult(NamedTuple):
    """Device outputs for one batch (I2 = B * best_n selected alignments).

    Traceback is walked ON DEVICE (ops/traceback_device.py) — only the
    2-bit-packed move strings and per-alignment stats cross the host link,
    never the (S, I2, W) arrow tensor. All scalar per-item outputs are packed
    into sel_ints/read_ints so that a batch needs few transfers.
    """

    sel_ints: jax.Array      # (len(SEL_FIELDS), I2) int32, rows = SEL_FIELDS
    moves_packed: jax.Array  # (I2, P) uint8 packed ops, END->START order
    read_ints: jax.Array     # (B, 6*CD + 1) int32: cand_scores |
                             # cand_valid | chain corners qlo|qhi|tlo|thi
                             # (the reference interval geometry) | ambig
                             # (a second window passed admission)


class WireResult(NamedTuple):
    """Single-buffer device result (one device-to-host copy per batch).

    The three MapBatchResult arrays are bitcast to uint8 and concatenated
    on device; the host fetches ONE buffer and slices views. Static dims
    travel host-side (not through jit).
    """

    wire: jax.Array   # (N,) uint8: sel_ints | moves_packed | read_ints
    i2: int           # B * best_n
    p: int            # packed move-string width
    b: int            # batch rows
    rcols: int        # read_ints columns = 2 * dp_candidates


class HostBatchResult(NamedTuple):
    """Numpy view of MapBatchResult after a single host transfer per array."""

    sel_score: np.ndarray
    sel_t0: np.ndarray
    sel_strand: np.ndarray
    sel_valid: np.ndarray
    nops: np.ndarray
    q_start: np.ndarray
    q_end: np.ndarray
    t_start: np.ndarray
    t_end: np.ndarray
    n_match: np.ndarray
    n_mismatch: np.ndarray
    n_ins: np.ndarray
    n_del: np.ndarray
    mapqv: np.ndarray        # per selected alignment (I2,)
    sel_cd: np.ndarray       # DP-candidate index of each selected record
    moves_packed: np.ndarray
    cand_scores: np.ndarray
    cand_valid: np.ndarray
    cand_qlo: np.ndarray     # (B, CD) chain read-span corners
    cand_qhi: np.ndarray
    cand_tlo: np.ndarray     # (B, CD) chain genome-span corners
    cand_thi: np.ndarray
    cand_ambig: np.ndarray   # (B,) a second window passed admission


def unpack_result(
    res: "MapBatchResult | WireResult", dp_candidates: int
) -> HostBatchResult:
    if isinstance(res, WireResult):
        wire = res.wire if isinstance(res.wire, np.ndarray) else np.asarray(res.wire)
        nsel = len(SEL_FIELDS) * res.i2 * 4
        nmov = res.i2 * res.p
        sel = wire[:nsel].view(np.int32).reshape(len(SEL_FIELDS), res.i2)
        moves = wire[nsel : nsel + nmov].reshape(res.i2, res.p)
        rints = wire[nsel + nmov :].view(np.int32).reshape(res.b, res.rcols)
    else:
        sel = np.asarray(res.sel_ints)
        moves = np.asarray(res.moves_packed)
        rints = np.asarray(res.read_ints)
    CD = dp_candidates
    fields = {name: sel[i] for i, name in enumerate(SEL_FIELDS)}
    fields["sel_valid"] = fields["sel_valid"].astype(bool)
    return HostBatchResult(
        moves_packed=moves,
        cand_scores=rints[:, :CD],
        cand_valid=rints[:, CD : 2 * CD].astype(bool),
        cand_qlo=rints[:, 2 * CD : 3 * CD],
        cand_qhi=rints[:, 3 * CD : 4 * CD],
        cand_tlo=rints[:, 4 * CD : 5 * CD],
        cand_thi=rints[:, 5 * CD : 6 * CD],
        cand_ambig=rints[:, 6 * CD].astype(bool),
        **fields,
    )


DP_IMPLS = {"gpu": "cuda", "cpu": "xla"}


def dp_impl_for(platform: str) -> str:
    """The banded-DP implementation for a JAX platform.

    The GPU runs the CUDA kernel (ops/banded_gpu.py); the CPU runs XLA's
    scan (ops/banded_align.py), the reference the tests compare against.
    There is no silent fallback: any other platform raises.
    """
    try:
        return DP_IMPLS[platform]
    except KeyError:
        raise RuntimeError(
            f"no device path for platform {platform!r}: the mapper runs on "
            "an NVIDIA GPU, or on the CPU for tests"
        ) from None


def _revcomp_rows(codes: jax.Array, lengths: jax.Array) -> jax.Array:
    """Per-row reverse complement keeping reads left-aligned in padding.

    Complement + static flip leaves each rc read RIGHT-aligned at offset
    s = L - len; the left re-alignment shift is done as word-phase
    arithmetic (device nibble-pack 8 codes/int32, per-row WORD
    take_along_axis of L/8 elements, unpack, 8-way phase select) instead of
    a (B, L) per-element gather.
    """
    B, L = codes.shape
    comp = jnp.where(codes < 4, 3 - codes, codes).astype(jnp.int32)
    if L % 8 != 0:
        idx = lengths[:, None] - 1 - jnp.arange(L, dtype=jnp.int32)[None, :]
        ok = idx >= 0
        g = jnp.take_along_axis(comp, jnp.clip(idx, 0, L - 1), axis=1)
        return jnp.where(ok, g, 4).astype(jnp.uint8)
    flip = comp[:, ::-1]                                    # (B, L)
    w = (
        flip.reshape(B, L // 8, 8) << (jnp.arange(8, dtype=jnp.int32) * 4)
    ).sum(axis=2)                                           # (B, L/8)
    s = (L - lengths).astype(jnp.int32)
    NW = L // 8 + 1
    widx = (s >> 3)[:, None] + jnp.arange(NW, dtype=jnp.int32)[None, :]
    wv = jnp.take_along_axis(
        jnp.pad(w, ((0, 0), (0, 1))), jnp.clip(widx, 0, L // 8), axis=1
    )
    # sub-word re-alignment in the WORD domain (8x fewer elements than the
    # old per-code 8-way select), then one unpack
    wu = jax.lax.bitcast_convert_type(wv, jnp.uint32)
    wnext = jnp.concatenate([wu[:, 1:], wu[:, -1:]], axis=1)
    r = s & 7
    aligned = wu
    for ph in range(1, 8):
        cand = (wu >> jnp.uint32(4 * ph)) | (wnext << jnp.uint32(32 - 4 * ph))
        aligned = jnp.where((r == ph)[:, None], cand, aligned)
    nsh = jnp.arange(8, dtype=jnp.uint32) * 4
    b = ((aligned[:, :, None] >> nsh[None, None, :]) & 15).astype(jnp.uint8)
    out = b.reshape(B, NW * 8)[:, 0:L]
    ar = jnp.arange(L, dtype=jnp.int32)[None, :]
    return jnp.where(ar < lengths[:, None], out, jnp.uint8(4))


@functools.partial(
    jax.jit,
    static_argnames=(
        "params", "pad", "k", "genome_len", "dp", "index_kind", "fm_n",
        "lut_meta", "mesh",
    ),
)
def _map_batch_impl(
    codes: jax.Array,
    lengths: jax.Array,
    genome_pad: jax.Array,
    index_arrays: tuple,
    starts: jax.Array,
    qual: jax.Array | None = None,
    *,
    params: MappingParams,
    pad: int,
    k: int,
    genome_len: int,
    dp: str = "xla",                # banded-DP implementation (dp_impl_for)
    index_kind: str = "sa",
    fm_n: int = 0,
    lut_meta: tuple | None = None,
    mesh=None,                      # dp mesh the batch is sharded over
) -> MapBatchResult:
    B, L = codes.shape
    C = params.n_candidates
    T = L + params.target_pad
    W = params.band_width_for(L)
    CW = params.candidate_win
    G = genome_len

    # ---- strands ----
    rc = _revcomp_rows(codes, lengths)
    reads2 = jnp.concatenate([codes, rc], axis=0)          # (2B, L)
    lens2 = jnp.concatenate([lengths, lengths], axis=0)
    qual2 = None
    if qual is not None:
        # reverse (no complement) per-row, keeping left alignment
        idxq = lens2[B:, None] - 1 - jnp.arange(L, dtype=jnp.int32)[None, :]
        qrc = jnp.take_along_axis(qual, jnp.clip(idxq, 0, L - 1), axis=1)
        neutral = 15 | (15 << 8) if qual.dtype == jnp.uint16 else 15
        qrc = jnp.where(idxq >= 0, qrc, jnp.asarray(neutral, qual.dtype))
        qual2 = jnp.concatenate([qual, qrc], axis=0)

    # ---- anchoring ----
    if index_kind == "fm":
        bwt_rows, occ_bins, Cfm, ssa_mask, ssa_base, ssa_vals, pos_ok = index_arrays
        at, aq, anh, avalid = find_anchors_fm(
            reads2, lens2, bwt_rows, occ_bins, Cfm, ssa_mask, ssa_base,
            ssa_vals, pos_ok,
            k=k, n=fm_n,
            max_hits_per_pos=params.max_anchors_per_position,
            max_anchors_per_read=params.max_anchors_per_read,
            anchor_stride=params.anchor_stride,
        )
    elif k > 15:
        sa_masked, kmer_hi, kmer_lo, lut = index_arrays
        at, aq, anh, avalid = find_anchors_wide(
            reads2, lens2, sa_masked, kmer_hi, kmer_lo, lut,
            k=k,
            max_hits_per_pos=params.max_anchors_per_position,
            max_anchors_per_read=params.max_anchors_per_read,
            lut_meta=lut_meta,
            anchor_stride=params.anchor_stride,
            expand=params.min_expand,
        )
    elif lut_meta is not None and lut_meta[1] == 0:
        # direct-table index: compacted valid SA + count tables
        sa_valid, ctab16, lut_full, lut_valid = index_arrays
        at, aq, anh, avalid = find_anchors(
            reads2, lens2, sa_valid, None, None, lut_full, None, lut_valid,
            ctab16,
            k=k,
            max_hits_per_pos=params.max_anchors_per_position,
            max_anchors_per_read=params.max_anchors_per_read,
            lut_meta=lut_meta,
            anchor_stride=params.anchor_stride,
            expand=params.min_expand,
        )
    else:
        sa_masked, sa_kmers, lut, run_len = index_arrays
        at, aq, anh, avalid = find_anchors(
            reads2, lens2, sa_masked, sa_kmers, None, lut, run_len,
            k=k,
            max_hits_per_pos=params.max_anchors_per_position,
            max_anchors_per_read=params.max_anchors_per_read,
            lut_meta=lut_meta,
            anchor_stride=params.anchor_stride,
            expand=params.min_expand,
        )

    # ---- candidate windows ----
    aw = anchor_weights(anh, avalid, G, CW, params.pval_type)
    cand = select_candidates(
        at, aq, aw, avalid,
        n_candidates=C, win=CW, k=k,
    )                                                       # (2B, C)

    # ---- cross-strand DP-candidate selection: keep only the CD best
    # windows per read across both strands, so the DP runs on half the
    # items the strand-expanded layout would imply. (Role of
    # WeightedIntervalSet keeping top nCandidates across strands,
    # FindMaxInterval.h:839 + Blasr.cpp:2422-2441 fwd+rev into one set.)
    #
    # For -pvaltype 0/1 the ranking and the admission gate follow the
    # reference's chain p-value semantics (ops/candidates.chain_stats):
    # interval rank = colinear-chain size (ComputeLISPValue's log-p is
    # linear in chain count), p-value ties break on interval start
    # ascending (CompareWeightedIntervalByPValue, WeightedInterval.h:110),
    # and windows with no >=2-anchor colinear chain are rejected outright
    # (maxPValue = log(0.5), Blasr.cpp:2373 — a single-anchor interval's
    # p-value is 1 when no .ctab is present). -pvaltype 2/3 keep the
    # summed-anchor-weight ranking (LISSizeWeightor role).
    CD = params.n_dp_candidates or C
    to2 = lambda x: x.reshape(2, B, C).transpose(1, 0, 2).reshape(B, 2 * C)
    wgt2 = to2(cand.weight)
    vld2 = to2(cand.valid)
    if params.forward_only:
        # -forwardOnly: suppress the RC strand's candidates entirely
        vld2 = vld2 & (jnp.arange(2 * C, dtype=jnp.int32)[None, :] < C)
    b_ar = jnp.arange(B, dtype=jnp.int32)[:, None]
    if params.pval_type in (0, 1):
        n_chain, chained_any, cmass, ch_corners = chain_stats(
            at, aq, avalid, cand.dstar, cand.valid, k=k, win=CW,
        )                                                   # (2B, C)
        if params.exact_chain:
            # reference GlobalChain ranking: exact max-weight colinear
            # chain per window (ops/candidates.chain_weight_device,
            # oracle-tested vs global_chain_exact); the admission gates
            # (chained_any, minInterval mass) are unchanged
            from blasr_jax.ops.candidates import chain_weight_device

            n_chain = chain_weight_device(
                at, aq, avalid, cand.dstar, cand.valid, k=k, win=CW,
            )
        nch2 = to2(n_chain)
        # interval admission (FindMaxInterval.h:832): a colinear chain OR a
        # long bare match (maxPValue), AND anchor coverage above this
        # fork's minInterval=100 default (MappingParameters.h:348) — the
        # gate that keeps bare-repeat-match windows out of the queue
        vld2 = vld2 & to2(chained_any) & (
            to2(cmass) > jnp.int32(params.min_interval)
        )
        # tie order: interval start ascending -> rank windows per read by
        # genomic start (d0 + q_lo), smaller start wins equal chain counts
        gst2 = to2(cand.d0 + cand.q_lo)
        grank = jnp.argsort(
            jnp.argsort(jnp.where(vld2, gst2, jnp.int32(2**30)), axis=1),
            axis=1,
        ).astype(jnp.int32)                                 # (B, 2C)
        key = jnp.where(
            vld2,
            (jnp.minimum(nch2, 1 << 14) << 15) - grank,
            jnp.int32(-1),
        )
        topw, topj = jax.lax.top_k(key, CD)                 # (B, CD)
        cvalid = (topw > 0).reshape(-1)
        # second-admitted-window flag (adaptive_cd trigger): exact — a
        # read without one behaves identically at any CD
        ambig = jax.lax.top_k(key, 2)[0][:, 1] > 0
    else:
        wneg = jnp.where(vld2, wgt2, jnp.float32(-1.0))
        topw, topj = jax.lax.top_k(wneg, CD)                # (B, CD)
        cvalid = (topw > 0.0).reshape(-1)
        ambig = jax.lax.top_k(wneg, 2)[0][:, 1] > 0.0
    dp_strand = (topj // C).astype(jnp.int32)               # 0 fwd / 1 rc
    dp_c = (topj % C).astype(jnp.int32)
    cand_item = (dp_strand * B + b_ar) * C + dp_c           # into (2B*C,) layout
    cand_flat = cand_item.reshape(-1)                       # (I,) I = B*CD
    I = B * CD

    d0 = jnp.clip(cand.d0.reshape(-1)[cand_flat], -L, G - 1)
    row = (dp_strand * B + b_ar).reshape(-1)                # (I,) strand row

    scores_cfg = AlignScores(
        match=params.match_score,
        mismatch=params.mismatch_score,
        insertion=params.insertion_score,
        deletion=params.deletion_score,
        affine_open=params.affine_open,
        affine_extend=params.affine_extend,
        matrix=params.score_matrix,
    )
    # ---- drift-slope band schedule (role of GuidedAlign.h:104's
    # drift-following Guide): fit per-item chain slope d(q) over the
    # window's anchors, take the batch median, and bias the shared band
    # schedule so systematic ins/del drift stays centred. This is what
    # lets the narrow (packed) band replace the reference's band-16 guide.
    #
    # The schedule (and its slope) is one vector shared by all items, but
    # each item's WINDOW POSITION is free. Per-item min-max centring below plays the
    # reference's per-read guide role for heterogeneous batches: evaluate
    # each member anchor's deviation from the shared band-centre line and
    # shift the item's target window so the worst positive and negative
    # deviations balance. An item whose own drift disagrees with the batch
    # median (mixed ins-heavy/del-heavy batches) gets its residual split
    # across both band edges instead of accumulating at one end.
    pad2 = params.target_pad // 2
    # per-item anchor rows serve both the slope/centring fit and the knot
    # guides: gather once, with (aq, valid) packed into one int32 so the
    # three per-element row gathers become two
    atr = aqr = avr = None
    if W < 128 or (params.guided_band and L >= W):
        aqv_pack = (aq << 1) | avalid.astype(jnp.int32)
        atr = at[row]                                       # (I, A)
        _qp = aqv_pack[row]
        aqr = _qp >> 1
        avr = (_qp & 1).astype(bool)
    if W < 128:
        din = atr - aqr - d0[:, None]
        m = avr & (jnp.abs(din) <= CW)
        mf = m.astype(jnp.float32)
        qf = aqr.astype(jnp.float32) * mf
        df = din.astype(jnp.float32) * mf
        n_a = mf.sum(1)
        sq = qf.sum(1)
        sd = df.sum(1)
        sqq = (qf * qf * jnp.where(m, 1.0, 0.0)).sum(1)
        sqd = (qf * df).sum(1)
        denom = n_a * sqq - sq * sq
        ok = (n_a >= 3) & (denom > 1e3)
        slope_i = jnp.where(ok, (n_a * sqd - sq * sd) / jnp.maximum(denom, 1.0), jnp.nan)
        slope_med = jnp.nan_to_num(
            jnp.nanmedian(jnp.where(cvalid, slope_i, jnp.nan)), nan=0.0
        )
        slope_med = jnp.clip(slope_med, -0.15, 0.15)
        qoff_num = jnp.round(
            jnp.float32(1 << QOFF_SHIFT) / (2.0 + slope_med)
        ).astype(jnp.int32)
        # per-item centring: anchor (q, t) sits on anti-diagonal
        # a = 2q + din + pad2 of its window; the shared centre line puts
        # the band middle at ((a - pad2) * num) >> 16, so the anchor's
        # band-coordinate deviation is dev = that - q. Shifting the window
        # by dt moves every dev by -dt * num >> 16; balance max and min.
        dev = (((2 * aqr + din) * qoff_num) >> QOFF_SHIFT) - aqr
        dev_max = jnp.max(jnp.where(m, dev, -(1 << 30)), axis=1)
        dev_min = jnp.min(jnp.where(m, dev, 1 << 30), axis=1)
        have = jnp.any(m, axis=1) & cvalid
        dt = ((dev_max + dev_min) << (QOFF_SHIFT - 1)) // jnp.maximum(
            qoff_num, 1
        )
        dt = jnp.clip(dt, -pad2 // 2, pad2 // 2)
        d0 = jnp.where(have, d0 + dt, d0)
    else:
        qoff_num = jnp.int32(QOFF_NUM_HALF)
    qoff = make_qoff_num(L, T, W, pad2, qoff_num)

    # ---- per-item guided band (GuidedAlign.h:104 AlignmentToGuide role,
    # the reference's default refinement at Blasr.cpp:869): each read's DP
    # band follows a knot schedule lerped through its own member anchors,
    # so bursty indel drift that the shared straight line cannot track
    # stays inside the base-width band — long buckets keep W=128 instead
    # of the length-scaled fallback (params.band_width_for).
    knots = None
    if params.guided_band and L >= W:
        S_dp = L + T - 1
        aqr_g = aqr
        din_g = atr - aqr - d0[:, None]
        m_g = avr & (jnp.abs(din_g) <= CW) & cvalid[:, None]
        # window coords: t_loc = at - t0f = din + aq + pad2, so the anchor
        # sits on anti-diagonal a = q + t_loc = 2q + din + pad2
        knots = make_qoff_knots(
            2 * aqr_g + din_g + pad2, aqr_g - W // 2, m_g,
            S_dp, L, W, diag=pad2, num=qoff_num,
        )
        knots = clamp_knots_to_shared(knots, qoff, W)

    t0f = d0 - pad2                                         # (I,) global

    # target-window fetch from the nibble-packed genome (8 codes/int32, see
    # make_device_index): gather T/8+2 words per item, unpack nibbles, then
    # pick the (start & 7) byte phase with a static-slice select chain
    I_items = t0f.shape[0]
    gpos = t0f + pad                                        # (I,) >= 0
    word0 = gpos >> 3
    phase = gpos & 7
    NW8 = T // 8 + 2
    widx = word0[:, None] + jnp.arange(NW8, dtype=jnp.int32)[None, :]
    wv = genome_pad[jnp.clip(widx, 0, genome_pad.shape[0] - 1)]
    # phase-align in the WORD domain (8x fewer elements than selecting
    # per-code): combine each word with its successor shifted by 4*phase
    # bits, THEN unpack nibbles once — the old 8-way select over the
    # (I, T) code array was the dominant setup cost
    wu = jax.lax.bitcast_convert_type(wv, jnp.uint32)
    wnext = jnp.concatenate([wu[:, 1:], wu[:, -1:]], axis=1)
    aligned = wu
    for _p in range(1, 8):
        sh = jnp.uint32(4 * _p)
        cand = (wu >> sh) | (wnext << jnp.uint32(32 - 4 * _p))
        aligned = jnp.where((phase == _p)[:, None], cand, aligned)
    nsh = jnp.arange(8, dtype=jnp.uint32) * 4
    bts = ((aligned[:, :, None] >> nsh[None, None, :]) & 15).astype(jnp.uint8)
    tcodes = bts.reshape(I_items, NW8 * 8)[:, 0:T]

    # contig bounds for boundary masking
    mid = jnp.clip(t0f + T // 2, 0, G - 1)
    ci = jnp.searchsorted(starts, mid, side="right") - 1
    ci = jnp.clip(ci, 0, starts.shape[0] - 2)
    tlo = jnp.maximum(starts[ci] - t0f, 0).astype(jnp.int32)
    thi = jnp.minimum(starts[ci + 1] - t0f, T).astype(jnp.int32)

    # query row fetch: nibble-pack reads2 once (8 codes/int32 word), row-
    # gather L/8 WORDS per item and unpack — 8x fewer gathered elements
    # than reads2[row] (same trick as the genome window fetch above)
    if L % 8 == 0:
        r2w = (
            reads2.astype(jnp.int32).reshape(2 * B, L // 8, 8)
            << (jnp.arange(8, dtype=jnp.int32) * 4)
        ).sum(axis=2)                                       # (2B, L/8)
        qw = r2w[row]                                       # (I, L/8)
        nshq = jnp.arange(8, dtype=jnp.int32) * 4
        qitems = (
            ((qw[:, :, None] >> nshq[None, None, :]) & 15)
            .astype(jnp.uint8)
            .reshape(-1, L)
        )
    else:
        qitems = reads2[row]                                # (I, L)
    qlens = lens2[row]
    quitems = qual2[row] if qual2 is not None else None

    # ---- ONE DP pass with traceback over every candidate; the arrow
    # tensor stays in device memory and the walk below reads it in place.
    qoff_dp = qoff if knots is None else qoff_from_knots(knots, L + T - 1)
    with jax.named_scope("banded_dp"):
        if dp == "cuda" and kernel_handles(W):
            res1 = banded_align_gpu(
                qitems, qlens, tcodes, tlo, thi, qoff_dp, quitems,
                scores=scores_cfg, band_width=W, mesh=mesh,
            )
        else:
            res1 = banded_align(
                qitems, qlens, tcodes, tlo, thi, qoff_dp, quitems,
                scores=scores_cfg, with_traceback=True, band_width=W,
            )
    cscore = jnp.where(cvalid, res1.score, 0)               # (I,)

    # ---- on-device traceback walk over ALL candidates, in place over the
    # arrow tensor (arrows never leave the chip). Walking every candidate
    # instead of just the winners costs ~nothing (the walk is bound by
    # iteration count, not item count) and yields the per-candidate
    # match/indel stats the reference MAPQ rescore needs
    # (SMRTLogProbMatrix replay, Blasr.cpp:2780-2785).
    with jax.named_scope("traceback_walk"):
        tb = walk_arrows_device(
            res1.arrows, qoff, res1.best_a, res1.best_w,
            cscore, qitems, tcodes,
            qoff_params=(params.target_pad // 2, W, L),
            qoff_num=qoff_num,
            qoff_knots=knots,
        )

    sc = cscore.reshape(B, CD)
    sv = cvalid.reshape(B, CD) & (sc < 0)

    # ---- RemoveOverlappingAlignments (Blasr.cpp:2081-2161): drop a
    # candidate whose GENOMIC interval is contained in a same-strand
    # candidate with an equal-or-better score (earlier index wins ties).
    # This kills duplicate placements of one locus that survived candidate
    # NMS in different windows, before both best_n selection and MAPQ.
    gt_lo = (t0f + tb.t_start).reshape(B, CD)
    gt_hi = (t0f + tb.t_end).reshape(B, CD)
    d_ = lambda x: x[:, :, None]                            # container axis
    c_ = lambda x: x[:, None, :]                            # containee axis
    idx_cd = jnp.arange(CD, dtype=jnp.int32)[None, :]
    contains = (
        (d_(gt_lo) <= c_(gt_lo))
        & (d_(gt_hi) >= c_(gt_hi))
        & (d_(dp_strand) == c_(dp_strand))
        & d_(sv) & c_(sv)
        & (idx_cd[:, :, None] != idx_cd[:, None, :])
    )
    better = (d_(sc) < c_(sc)) | (
        (d_(sc) == c_(sc)) & (idx_cd[:, :, None] < idx_cd[:, None, :])
    )
    # ---- RemoveContained (WeightedInterval.h:128-181, called
    # Blasr.cpp:2499): drop a candidate whose FORWARD-READ span is
    # contained in a better candidate's span (containment implies
    # overlapRatio 1 > the 0.9 gate) — this is what collapses repeat
    # placements of the same read interval before -bestn emission,
    # regardless of strand or contig.
    rlen_ = lengths[:, None].astype(jnp.int32)
    rq_lo = tb.q_start.reshape(B, CD)
    rq_hi = tb.q_end.reshape(B, CD)
    is_rc_ = dp_strand == 1
    rq_lo, rq_hi = (
        jnp.where(is_rc_, rlen_ - rq_hi, rq_lo),
        jnp.where(is_rc_, rlen_ - rq_lo, rq_hi),
    )
    # STRICT read-span containment, verified against the reference:
    # WeightedInterval.h:168 erases only when nextStart >= curStart and
    # nextEnd <= curEnd (the 0.9-ratio branch is unreachable for partial
    # overlaps) — a looser ratio gate would suppress records the
    # reference emits
    contains_read = (
        (d_(rq_lo) <= c_(rq_lo))
        & (d_(rq_hi) >= c_(rq_hi))
        & d_(sv) & c_(sv)
        & (idx_cd[:, :, None] != idx_cd[:, None, :])
    )
    removed = jnp.any(contains & better, axis=1)            # (B, CD)
    sv = sv & ~removed
    # read-span containment gates EMISSION only; MAPQ keeps the full
    # competitor set (ambiguity must still be visible to the logsumexp).
    # Containers must themselves have SURVIVED the genomic removal
    # (reference order: RemoveOverlapping at Blasr.cpp:2618 acts on the
    # already-filtered list) — a dead candidate cannot suppress others.
    if params.remove_contained:
        alive = sv[:, :, None]                              # container axis
        removed_read = jnp.any(contains_read & better & alive, axis=1)
        sv_emit = sv & ~removed_read
    else:
        sv_emit = sv

    # ---- per-read best_n selection over the surviving candidates,
    # reference order: score ascending, ties by tPos + tAlignedSeqPos
    # (SortAlignmentPointersByScore, Blasr.cpp:226-236). For REVERSE-strand
    # alignments tAlignedSeqPos was converted to RC-space before this sort
    # (Blasr.cpp:1316-1323 MakeRCCoordinate), so the tie coordinate is the
    # alignment start in the strand's own reported space: fwd start for
    # strand 0, G - fwd_end for strand 1. (Verified on the golden corpus:
    # every equal-score rc repeat tie follows ascending RC-space start.)
    # Two stable argsorts give the lexicographic (score, tiepos) order.
    BIG = jnp.int32(2**30)
    tie_pos = jnp.where(dp_strand == 1, jnp.int32(G) - gt_hi, gt_lo)
    o1 = jnp.argsort(jnp.where(sv_emit, tie_pos, BIG), axis=1, stable=True)
    sc_o1 = jnp.take_along_axis(jnp.where(sv_emit, sc, BIG), o1, axis=1)
    o2 = jnp.argsort(sc_o1, axis=1, stable=True)
    order_cd = jnp.take_along_axis(o1, o2, axis=1)          # (B, CD)
    topi = order_cd[:, : params.best_n]                    # (B, best_n)
    topv = -jnp.take_along_axis(jnp.where(sv_emit, sc, BIG), topi, axis=1)
    sel_item = (b_ar * CD + topi).reshape(-1)               # (I2,) into DP items
    sel_strand = jnp.take_along_axis(dp_strand, topi, axis=1)
    sel_valid = (topv > -BIG).reshape(-1) & (topv.reshape(-1) > 0)

    # ---- MAPQ over all candidates, reference algorithm (ops/mapqv.py) ----
    # forward-read aligned intervals per candidate: RC-strand walks carry
    # RC-read coordinates; flip so cross-strand competitors overlap correctly
    rlen = lengths[:, None].astype(jnp.int32)
    wq_lo = tb.q_start.reshape(B, CD)
    wq_hi = tb.q_end.reshape(B, CD)
    is_rc = dp_strand == 1
    wq_lo, wq_hi = (
        jnp.where(is_rc, rlen - wq_hi, wq_lo),
        jnp.where(is_rc, rlen - wq_lo, wq_hi),
    )
    mapq_all = map_qv_reference(
        sc, sv & (sc < 0),
        wq_lo, wq_hi,
        tb.n_match.reshape(B, CD), tb.n_mismatch.reshape(B, CD),
        tb.n_ins.reshape(B, CD), tb.n_del.reshape(B, CD),
        ins_cost=params.insertion_score, del_cost=params.deletion_score,
    )                                                        # (B, CD)
    sel_mapq = jnp.take_along_axis(mapq_all, topi, axis=1).reshape(-1)

    sel_score = res1.score[sel_item]
    sel_ints = jnp.stack(
        [
            sel_score,
            t0f[sel_item],
            sel_strand.reshape(-1),
            sel_valid.astype(jnp.int32),
            tb.nops[sel_item],
            tb.q_start[sel_item],
            tb.q_end[sel_item],
            tb.t_start[sel_item],
            tb.t_end[sel_item],
            tb.n_match[sel_item],
            tb.n_mismatch[sel_item],
            tb.n_ins[sel_item],
            tb.n_del[sel_item],
            sel_mapq,
            topi.reshape(-1),
        ]
    ).astype(jnp.int32)
    # anchor-chain corners of each DP candidate (WeightedInterval
    # qStart/qEnd/tStart/tEnd): the host secondary admission rebuilds the
    # reference's corner-anchored interval from these (Blasr.cpp:1247-63)
    if params.pval_type in (0, 1):
        qlo_c, qhi_c, tlo_c, thi_c = ch_corners
    else:
        qlo_c, qhi_c = cand.q_lo, cand.q_hi
        tlo_c = cand.d0 + cand.q_lo
        thi_c = cand.d0 + cand.q_hi + k
    qlo_sel = jnp.take_along_axis(to2(qlo_c), topj, axis=1)
    qhi_sel = jnp.take_along_axis(to2(qhi_c), topj, axis=1)
    tlo_sel = jnp.take_along_axis(to2(tlo_c), topj, axis=1)
    thi_sel = jnp.take_along_axis(to2(thi_c), topj, axis=1)
    read_ints = jnp.concatenate(
        [sc, sv.astype(jnp.int32), qlo_sel, qhi_sel, tlo_sel, thi_sel,
         ambig.astype(jnp.int32)[:, None]],
        axis=1,
    ).astype(jnp.int32)

    emit_moves = params.emit_moves or params.best_n > 1
    moves_sel = tb.moves_codes[sel_item] if emit_moves else None
    if emit_moves:
        moves_packed = pack_codes_rows(
            moves_sel, tb.nops[sel_item], packed_width(L + T - 1)
        )
    else:
        # m4-style serving: coordinates and stats (sel_ints) fully
        # determine the output, so no move strings cross to the host
        moves_packed = jnp.zeros((sel_item.shape[0], 0), jnp.uint8)
    return MapBatchResult(
        sel_ints=sel_ints,
        moves_packed=moves_packed,
        read_ints=read_ints,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "params", "pad", "k", "genome_len", "dp", "index_kind", "fm_n",
        "lut_meta", "mesh",
    ),
)
def _map_batch_wire(codes, lengths, genome_pad, index_arrays, starts, qual=None, **kw):
    """_map_batch_impl + on-device flattening to one uint8 wire buffer."""
    res = _map_batch_impl(codes, lengths, genome_pad, index_arrays, starts, qual, **kw)
    sel8 = jax.lax.bitcast_convert_type(res.sel_ints, jnp.uint8).reshape(-1)
    rd8 = jax.lax.bitcast_convert_type(res.read_ints, jnp.uint8).reshape(-1)
    return jnp.concatenate([sel8, res.moves_packed.reshape(-1), rd8])


@dataclasses.dataclass
class Mapper:
    """Holds the device index and dispatches jitted map steps per bucket.

    With params.ndevices != 1 the batch axis is sharded over a 1-D ``dp``
    mesh and the index is replicated (reference §2.9 data parallelism:
    N pthreads over a shared index, Blasr.cpp:4794-4849) — XLA runs the
    same program SPMD; outputs gather on fetch.
    """

    index: GenomeIndex
    params: MappingParams
    fm: object = None  # optional FMIndex for the -bwt anchoring path

    def __post_init__(self):
        # fail fast with the MakeSane-style message instead of an obscure
        # shape error downstream (e.g. best_n > dp_candidates broke the
        # wire unpack reshape)
        self.params.validate()
        self.device_index = make_device_index(self.index, self.params, fm=self.fm)
        # the DP follows the device the index was placed on, so a Mapper
        # built under jax.default_device(cpu) runs the CPU path
        (dev,) = self.device_index.genome_pad.devices()
        self.dp = dp_impl_for(dev.platform)
        self.mesh = None
        nd = self.params.ndevices
        if nd != 1:
            import jax as _jax

            from blasr_jax.parallel.mesh import make_mesh, replicate_index

            avail = len(_jax.devices())
            nd = avail if nd == 0 else min(nd, avail)
            if nd > 1 and self.params.batch_size % nd == 0:
                self.mesh = make_mesh(nd)
                self.device_index = replicate_index(self.mesh, self.device_index)

    def map_batch(
        self,
        codes: np.ndarray,
        lengths: np.ndarray,
        qual: np.ndarray | None = None,
    ) -> WireResult:
        di = self.device_index
        p = self.params
        if self.mesh is not None:
            import jax as _jax
            from jax.sharding import NamedSharding, PartitionSpec as P

            dp2 = NamedSharding(self.mesh, P("dp", None))
            dp1 = NamedSharding(self.mesh, P("dp"))
            codes_d = _jax.device_put(codes, dp2)
            lengths_d = _jax.device_put(lengths, dp1)
            q = None
            if qual is not None and not p.ignore_qualities:
                q = _jax.device_put(qual, dp2)
        else:
            codes_d = jnp.asarray(codes)
            lengths_d = jnp.asarray(lengths)
            q = None
            if qual is not None and not p.ignore_qualities:
                q = jnp.asarray(qual)
        wire = _map_batch_wire(
            codes_d,
            lengths_d,
            di.genome_pad, di.arrays, di.starts,
            q,
            params=p, pad=di.pad, k=di.k, genome_len=di.genome_len,
            dp=self.dp, index_kind=di.kind, fm_n=di.fm_n,
            lut_meta=di.lut_meta, mesh=self.mesh,
        )
        from blasr_jax.ops.traceback_device import packed_width

        B, L = codes.shape
        S = L + p.target_pad + L - 1
        return WireResult(
            wire=wire,
            i2=B * p.best_n,
            p=packed_width(S) if (p.emit_moves or p.best_n > 1) else 0,
            b=B,
            rcols=6 * p.dp_candidates + 1,
        )

