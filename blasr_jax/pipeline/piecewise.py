"""Piecewise long-query mapping (-alignContigs path).

Role of reference ``common/algorithms/anchoring/PiecewiseMatch.h`` (:400,
called from Blasr.cpp:2408-2420) + the ``-alignContigs`` preset
(MappingParameters.h:453-478): multi-megabase queries are matched as
strand-tagged segments, chains split at strand switches or large gaps, and
each resulting piece reported as its own interval. The reference keeps the
cost near-linear by only densely aligning inter-anchor gaps; here the
long query is cut into fixed-size segments (the device's natural unit — each
segment is one padded batch row), every segment maps through the standard
device pipeline, and compatible neighboring segment alignments stitch into
piecewise interval records on the host.

This is the framework's sequence-axis decomposition: the long-context
analogue where query segments are the shards and the stitcher plays the
halo-exchange role (SURVEY.md §5 long-context note).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from blasr_jax.index.artifacts import GenomeIndex
from blasr_jax.io.batching import Read
from blasr_jax.params import MappingParams
from blasr_jax.pipeline.runner import AlignmentRecord, run_mapping
from blasr_jax.pipeline.traceback import OP_D, OP_I, OP_M, AlignmentPath

SEG_SEP = "\x01seg\x01"


def split_long_reads(
    reads: Sequence[Read], seg_len: int, split_if_longer: int | None = None
) -> tuple[list[Read], dict[str, Read]]:
    """Cut reads longer than split_if_longer (default: seg_len) into
    abutting seg_len segments.

    Segment names encode (parent, index, offset); returns (mapping input,
    parent lookup).
    """
    threshold = seg_len if split_if_longer is None else split_if_longer
    out: list[Read] = []
    parents: dict[str, Read] = {}
    for r in reads:
        if len(r) <= threshold:
            out.append(r)
            continue
        parents[r.name] = r
        n_seg = -(-len(r) // seg_len)
        for si in range(n_seg):
            ofs = si * seg_len
            seg = r.codes[ofs : ofs + seg_len]
            q = r.qual[ofs : ofs + seg_len] if r.qual is not None else None
            out.append(
                Read(f"{r.name}{SEG_SEP}{si}{SEG_SEP}{ofs}", seg, q, len(out))
            )
    return out, parents


def _try_stitch(
    a: AlignmentRecord, b: AlignmentRecord, max_gap: int, indel_rate: float
) -> bool:
    """Can segment-alignment b continue the piecewise run ending at a?"""
    if a.tname != b.tname or a.tstrand != b.tstrand:
        return False
    # q-gap between consecutive segments in FORWARD read coords
    q_gap = b.qstart - a.qend
    if a.tstrand == 0:
        t_gap = b.tstart_fwd - a.tend_fwd
    else:
        # reverse strand: later read segments hit earlier target coords
        t_gap = a.tstart_fwd - b.tend_fwd
    if t_gap < -64 or q_gap < -64:
        return False
    if t_gap > max_gap or q_gap > max_gap:
        return False
    drift = abs(t_gap - q_gap)
    return drift <= max(64, int(indel_rate * max(q_gap, t_gap, 1)) + 64)


def _trim_leading(ops: np.ndarray, q_trim: int, t_trim: int):
    """Drop leading ops until >= q_trim query and >= t_trim target bases are
    consumed (resolves small overlaps between stitched segments). Returns
    (ops, q_dropped, t_dropped, m_dropped)."""
    qd = td = md = 0
    i = 0
    n = len(ops)
    while i < n and (qd < q_trim or td < t_trim):
        op = ops[i]
        if op == OP_I:
            qd += 1
        elif op == OP_D:
            td += 1
        else:
            qd += 1
            td += 1
            md += 1
        i += 1
    return ops[i:], qd, td, md


def _gap_stats(ops: np.ndarray, q: np.ndarray, t: np.ndarray):
    """(n_match, n_mismatch, n_ins, n_del) of an op string over q/t."""
    qstep = (ops != OP_D).astype(np.int64)
    tstep = (ops != OP_I).astype(np.int64)
    qpos = np.cumsum(qstep) - qstep
    tpos = np.cumsum(tstep) - tstep
    ism = ops == OP_M
    if ism.any():
        qc = q[qpos[ism]]
        tc = t[tpos[ism]]
        nm = int(np.count_nonzero((qc == tc) & (qc < 4)))
    else:
        nm = 0
    nmop = int(np.count_nonzero(ism))
    return (
        nm,
        nmop - nm,
        int(np.count_nonzero(ops == OP_I)),
        int(np.count_nonzero(ops == OP_D)),
    )


def _merge_run(
    run: list[AlignmentRecord], parent: Read, index: GenomeIndex,
    params: MappingParams,
) -> AlignmentRecord:
    """Fuse a chain of compatible segment alignments into one record.

    Ops concatenate in PATH order — target-ascending — which for
    reverse-strand hits is the reverse of the forward-read segment order.
    Inter-segment gaps <= piecewise_max_gap are DENSELY ALIGNED with the
    host SDP/global filler (ops/sdp.py), matching the reference's
    refineBetweenAnchorsOnly inter-anchor fills (Blasr.cpp:1578-1634);
    small segment overlaps are trimmed from the later segment's leading ops.
    """
    from blasr_jax.core.encode import revcomp_codes
    from blasr_jax.ops.banded_align import AlignScores
    from blasr_jax.ops.sdp import sdp_align

    scores_cfg = AlignScores(
        match=params.match_score,
        mismatch=params.mismatch_score,
        insertion=params.insertion_score,
        deletion=params.deletion_score,
        affine_open=params.affine_open,
        affine_extend=params.affine_extend,
        matrix=params.score_matrix,
    )
    first, last = run[0], run[-1]
    strand = first.tstrand
    n = len(parent.codes)
    c_off = int(index.seqdb.starts[first.contig_index]) if first.contig_index >= 0 else 0
    # path (target-ascending) order: forward order for +, reversed for -
    path_order = run if strand == 0 else run[::-1]
    ops_parts: list[np.ndarray] = []
    score = 0
    nm = nmm = ni = nd = 0
    for i, rec in enumerate(path_order):
        p = rec.path
        seg_ops = np.asarray(p.ops, np.uint8)
        score += rec.score
        nm += p.n_match
        nmm += p.n_mismatch
        ni += p.n_ins
        nd += p.n_del
        if i > 0:
            prev = path_order[i - 1]
            # gaps in path coords: query gap is the unaligned read span
            # between the two segments, target gap the genome span
            if strand == 0:
                q_gap = rec.qstart - prev.qend
            else:
                q_gap = prev.qstart - rec.qend
            t_gap = rec.tstart_fwd - prev.tend_fwd
            if q_gap < 0 or t_gap < 0:
                seg_ops, qd, td, md = _trim_leading(
                    seg_ops, max(-q_gap, 0), max(-t_gap, 0)
                )
                q_gap += qd
                t_gap += td
                nm -= md          # approximation: trimmed M ops as matches
                ni -= max(qd - md, 0)
                nd -= max(td - md, 0)
            if q_gap > 0 and t_gap > 0:
                # dense/SDP fill of the inter-segment gap
                if strand == 0:
                    gq = parent.codes[prev.qend : prev.qend + q_gap]
                else:
                    gq = revcomp_codes(
                        parent.codes[rec.qend : rec.qend + q_gap]
                    )
                gt = index.genome[
                    c_off + prev.tend_fwd : c_off + prev.tend_fwd + t_gap
                ]
                g_ops, g_score = sdp_align(gq, gt, scores_cfg)
                gm, gmm, gi, gd = _gap_stats(g_ops, gq, gt)
                nm += gm
                nmm += gmm
                ni += gi
                nd += gd
                score += g_score
                ops_parts.append(g_ops)
            elif q_gap > 0:
                ops_parts.append(np.full(q_gap, OP_I, np.uint8))
                ni += q_gap
                score += q_gap * params.insertion_score
            elif t_gap > 0:
                ops_parts.append(np.full(t_gap, OP_D, np.uint8))
                nd += t_gap
                score += t_gap * params.deletion_score
        ops_parts.append(seg_ops)
    ops = np.concatenate(ops_parts)

    qs = first.qstart
    qe = last.qend
    ts_f = min(first.tstart_fwd, last.tstart_fwd)
    te_f = max(first.tend_fwd, last.tend_fwd)
    c_len = first.tlength
    if strand == 0:
        ts, te = ts_f, te_f
    else:
        ts, te = c_len - te_f, c_len - ts_f
    path = AlignmentPath(
        q_start=qs if strand == 0 else n - qe,
        q_end=qe if strand == 0 else n - qs,
        t_start=0,
        t_end=te_f - ts_f,
        ops=ops,
        score=score,
        n_match=nm,
        n_mismatch=nmm,
        n_ins=ni,
        n_del=nd,
    )
    return dataclasses.replace(
        first,
        score=score,
        pct_similarity=round(path.pct_similarity, 4),
        qstart=qs,
        qend=qe,
        qlength=n,
        tstart=ts,
        tend=te,
        tstart_fwd=ts_f,
        tend_fwd=te_f,
        mapqv=min(r.mapqv for r in run),
        path=path,
        read_index=parent.index,
    )


def _select_colinear(
    by_si: dict[int, list[AlignmentRecord]],
    max_gap: int,
    indel_rate: float,
    break_pen: int,
) -> list[AlignmentRecord]:
    """Choose one placement per segment minimizing total alignment score
    plus a penalty per chain break (joint colinear selection over each
    segment's top placements)."""
    sis = sorted(by_si)
    prev_dp: list[int] = []
    prev_cands: list[AlignmentRecord] = []
    back: list[list[int]] = []
    for si in sis:
        cands = by_si[si]
        dp_row: list[int] = []
        back_row: list[int] = []
        for c in cands:
            if not prev_cands:
                dp_row.append(c.score)
                back_row.append(-1)
                continue
            best_v = None
            best_j = -1
            for j, p in enumerate(prev_cands):
                pen = 0 if _try_stitch(p, c, max_gap, indel_rate) else break_pen
                v = prev_dp[j] + pen + c.score
                if best_v is None or v < best_v:
                    best_v = v
                    best_j = j
            dp_row.append(best_v)
            back_row.append(best_j)
        back.append(back_row)
        prev_dp = dp_row
        prev_cands = cands
    # backtrack
    chosen: list[AlignmentRecord] = []
    j = min(range(len(prev_dp)), key=lambda x: prev_dp[x]) if prev_dp else -1
    for i in range(len(sis) - 1, -1, -1):
        cands = by_si[sis[i]]
        chosen.append(cands[j])
        j = back[i][j]  # -1 only at i == 0 (loop ends)
    chosen.reverse()
    chosen.sort(key=lambda r: r.qstart)
    return chosen


def run_mapping_piecewise(
    index: GenomeIndex,
    reads: Sequence[Read],
    params: MappingParams,
    fm=None,
    split_if_longer: int | None = None,
) -> tuple[list[AlignmentRecord], list[str]]:
    """Map with long-query segmentation + piecewise stitching.

    ``split_if_longer`` keeps mid-size reads whole (the auto-segment path
    passes max_read_len so only reads beyond the pad bound segment);
    explicit -alignContigs segments everything above segment_length.
    """
    seg_len = min(params.segment_length, params.max_read_len)
    seg_reads, parents = split_long_reads(reads, seg_len, split_if_longer)
    base_params = dataclasses.replace(params, auto_segment=False)
    pass_through = [r for r in seg_reads if SEG_SEP not in r.name]
    segments = [r for r in seg_reads if SEG_SEP in r.name]
    # segments carry their top-3 placements: a segment inside a genomic
    # repeat would otherwise pick a copy independently and shatter the
    # chain; the colinear DP below re-selects jointly (role of the
    # reference's joint chaining across a contig, PiecewiseMatch.h:11-400,
    # vs per-segment best)
    SEG_BESTN = max(1, min(3, base_params.n_candidates,
                           base_params.dp_candidates))
    recs: list[AlignmentRecord] = []
    unmapped: list[str] = []
    if pass_through:
        r1, u1 = run_mapping(index, pass_through, base_params, fm=fm)
        recs += list(r1)
        unmapped += list(u1)
    if segments:
        # min_interval=0: the reference's minInterval admission floor
        # (FindMaxInterval.h:832) gates WHOLE-READ intervals — its anchor
        # sum accumulates over the full read. Applying the 100-base floor
        # to individual 1 kb segments over-rejects noisy segments and
        # shifts stitched starts; whole-read admission lives in the
        # stitcher's chain selection instead.
        seg_params = dataclasses.replace(
            base_params, best_n=SEG_BESTN, remove_contained=False,
            min_interval=0,
        )
        r2, u2 = run_mapping(index, segments, seg_params, fm=fm)
        recs += list(r2)
        unmapped += list(u2)

    by_parent: dict[str, dict[int, list[AlignmentRecord]]] = {}
    out: list[AlignmentRecord] = []
    for rec in recs:
        if SEG_SEP not in rec.qname:
            out.append(rec)
            continue
        pname, si, ofs = rec.qname.split(SEG_SEP)
        parent = parents[pname]
        ofs = int(ofs)
        # qstart/qend are forward-segment coords (blasr convention: qstrand
        # always 0), so the parent-forward shift is +ofs for either strand
        n_parent = len(parent.codes)
        shifted = dataclasses.replace(
            rec,
            qname=pname,
            qstart=rec.qstart + ofs,
            qend=rec.qend + ofs,
            qlength=n_parent,
        )
        by_parent.setdefault(pname, {}).setdefault(int(si), []).append(shifted)

    max_gap = params.piecewise_max_gap
    # a chain break costs the equivalent of ~800 matched bases: enough to
    # override repeat-copy score ties, small enough that a true structural
    # break (inversion/translocation, no colinear candidate) still splits
    BREAK_PEN = 800 * abs(params.match_score)
    for pname, by_si in by_parent.items():
        segs = _select_colinear(
            by_si, max_gap, params.indel_rate, BREAK_PEN
        )
        run: list[AlignmentRecord] = []
        for rec in segs:
            if run and _try_stitch(run[-1], rec, max_gap, params.indel_rate):
                run.append(rec)
            else:
                if run:
                    out.append(_merge_run(run, parents[pname], index, params))
                run = [rec]
        if run:
            out.append(_merge_run(run, parents[pname], index, params))

    mapped_parents = {r.qname for r in out}
    unmapped = [u for u in unmapped if SEG_SEP not in u]
    unmapped.extend(
        p for p in parents if p not in mapped_parents and p not in unmapped
    )
    order = {r.name: i for i, r in enumerate(reads)}
    out.sort(key=lambda a: (order.get(a.qname, 1 << 30), a.score))
    return out, unmapped
