"""m0 / m1 / m5 output formats (L6).

Roles of reference printers:
  m0 — StickAlignmentPrinter.h (human-readable block view)
  m1 — SummaryAlignmentPrinter.h ("qname tname qstrand tstrand score
        pctsimilarity tstart tend tlength qstart qend qlength ncells")
  m5 — CompareSequencesAlignmentPrinter.h ("qname qlength qstart qend
        qstrand tname tlength tstart tend tstrand score nummatch
        nummismatch numins numdel mapqv qalignedseq matchpattern
        talignedseq")
"""

from __future__ import annotations

from typing import IO, Iterable, Sequence

import numpy as np

from blasr_jax.core.encode import revcomp_codes
from blasr_jax.index.artifacts import GenomeIndex
from blasr_jax.io.batching import Read
from blasr_jax.pipeline.runner import AlignmentRecord
from blasr_jax.pipeline.traceback import OP_I, OP_M


def alignment_strings(
    rec: AlignmentRecord, read: Read, index: GenomeIndex, gap_char: str = "*"
):
    """Reconstruct (query_str, match_pattern, target_str) with gap dashes.

    gap_char: the match-pattern character over indels — '*' for m5/m1
    (reference turns spaces into '*' for parsing), ' ' for the m0 stick.
    """
    p = rec.path
    assert p is not None
    q = read.codes if rec.tstrand == 0 else revcomp_codes(read.codes)
    c_off = int(index.seqdb.starts[rec.contig_index])
    t = index.genome[c_off + rec.tstart_fwd : c_off + rec.tend_fwd]
    # vectorized replay: each op's query/target cursor is a prefix sum of
    # the ops that advance it (the per-op Python loop with a per-character
    # codes_to_seq call was the -m 5 formatting hot spot at bestn > 1)
    ops = np.asarray(p.ops)
    is_m = ops == OP_M
    is_i = ops == OP_I
    is_d = ~(is_m | is_i)
    adv_q = is_m | is_i
    adv_t = is_m | is_d
    qi = p.q_start + np.cumsum(adv_q) - adv_q          # cursor BEFORE op
    ti = np.cumsum(adv_t) - adv_t
    qc = np.asarray(q)[np.minimum(qi, len(q) - 1)].astype(np.uint8)
    tc = np.asarray(t)[np.minimum(ti, max(len(t) - 1, 0))].astype(np.uint8)
    GAP = np.uint8(5)                                  # lut index for '-'
    qcodes = np.where(is_d, GAP, np.minimum(qc, 4))
    tcodes = np.where(is_i, GAP, np.minimum(tc, 4))
    lut = np.frombuffer(b"ACGTN-", np.uint8)
    qstr = lut[qcodes].tobytes().decode("ascii")
    tstr = lut[tcodes].tobytes().decode("ascii")
    mb = np.where(
        is_m & (qcodes == tcodes) & (qcodes < 4),
        np.uint8(ord("|")),
        np.where(is_m, np.uint8(ord("*")), np.uint8(ord(gap_char))),
    )
    return qstr, mb.tobytes().decode("ascii"), tstr


def format_m1(rec: AlignmentRecord) -> str:
    return (
        f"{rec.qname} {rec.tname} {rec.qstrand} {rec.tstrand} {rec.score} "
        f"{rec.pct_similarity:.4f} {rec.tstart} {rec.tend} {rec.tlength} "
        f"{rec.qstart} {rec.qend} {rec.qlength} {rec.nhits_considered}"
    )


def format_m5(rec: AlignmentRecord, read: Read, index: GenomeIndex) -> str:
    """m5 strand convention (CompareSequencesAlignmentPrinter /
    PrintCompareSequencesAlignmentStats): strands are +/- characters and
    reverse-strand target coordinates are reported in FORWARD contig
    coordinates (unlike m4's RC convention)."""
    p = rec.path
    qstr, mstr, tstr = alignment_strings(rec, read, index)
    return (
        f"{rec.qname} {rec.qlength} {rec.qstart} {rec.qend} + "
        f"{rec.tname} {rec.tlength} {rec.tstart_fwd} {rec.tend_fwd} "
        f"{'+-'[rec.tstrand]} "
        f"{rec.score} {p.n_match} {p.n_mismatch} {p.n_ins} {p.n_del} "
        f"{rec.mapqv} {qstr} {mstr} {tstr}"
    )


def format_m0(rec: AlignmentRecord, read: Read, index: GenomeIndex, width: int = 50) -> str:
    """-m 0 human-readable block (field-for-field the reference's
    StickAlignmentPrinter + PrintAlignmentStats layout)."""
    p = rec.path
    qstr, mstr, tstr = alignment_strings(rec, read, index, gap_char=" ")
    lines = [
        f"    nMatch: {p.n_match}",
        f" nMisMatch: {p.n_mismatch}",
        f"      nIns: {p.n_ins}",
        f"      nDel: {p.n_del}",
        f"      %sim: {rec.pct_similarity:.4f}",
        f"     Score: {rec.score}",
        f"         Query: {rec.qname}",
        f"        Target: {rec.tname}",
        "         Model: a hybrid of global/local non-affine alignment",
        f"     Raw score: {rec.score}",
        f"        Map QV: {rec.mapqv}",
        f"  Query strand: {rec.qstrand}",
        f" Target strand: {rec.tstrand}",
        f"   QueryRange: {rec.qstart} -> {rec.qend} of {rec.qlength}",
        f"  TargetRange: {rec.tstart} -> {rec.tend} of {rec.tlength}",
    ]
    qpos = p.q_start if rec.tstrand == 0 else rec.qlength - p.q_end
    tpos = rec.tstart
    for ofs in range(0, len(qstr), width):
        qseg = qstr[ofs : ofs + width]
        mseg = mstr[ofs : ofs + width]
        tseg = tstr[ofs : ofs + width]
        lines.append(f"q: {qpos:4d}  {qseg}")
        lines.append(f"         {mseg}")
        lines.append(f"t: {tpos:4d}  {tseg}")
        lines.append("")
        qpos += sum(1 for c in qseg if c != "-")
        tpos += sum(1 for c in tseg if c != "-")
    return "\n".join(lines)


def write_verbose(
    records: Iterable[AlignmentRecord],
    reads: Sequence[Read],
    index: GenomeIndex,
    out: IO[str],
    fmt: int = 5,
    header: bool = False,
) -> None:
    by_name = {r.name: r for r in reads}
    if header and fmt == 1:
        # SummaryAlignmentPrinter::PrintHeader
        out.write(
            "qname tname qstrand tstrand score pctsimilarity tstart tend "
            "tlength qstart qend qlength ncells\n"
        )
    for rec in records:
        rd = by_name.get(rec.qname)
        if fmt == 1:
            out.write(format_m1(rec) + "\n")
        elif fmt == 3:
            out.write(format_m3(rec) + "\n")
        elif rd is None:
            continue
        elif fmt == 0:
            out.write(format_m0(rec, rd, index) + "\n")
        elif fmt == 2:
            out.write(format_m2(rec, rd, index) + "\n")
        else:
            out.write(format_m5(rec, rd, index) + "\n")


def format_m2(rec: AlignmentRecord, read: Read, index: GenomeIndex) -> str:
    """-m 2 XML output (role of XMLAlignmentPrinter.h CompareXMLPrintAlignment).

    Field semantics follow the reference: query start/end in the reported
    strand orientation, percent fields use n*0.5/alignLength, and the
    alignment strings carry gap dashes.
    """
    p = rec.path
    assert p is not None
    qstr, mstr, tstr = alignment_strings(rec, read, index)
    aln_len = max(len(mstr), 1)
    strand = "+-"[rec.tstrand]
    lines = [
        (
            f'<hit name="{rec.qname}" unalignedLength="{rec.qlength}" '
            f'start="{rec.qstart}" end="{rec.qend}" strand="{"+-"[rec.qstrand]}" '
            f'targetStart="{rec.tstart}" targetEnd="{rec.tend}" '
            f'targetStrand="{strand}">'
        ),
        f'<zScore value="{0.0:.3f}"/>',
        f'<nInsert value="{p.n_ins}" percent="{p.n_ins * 0.5 / aln_len:.2f}" />',
        f'<nDelete value="{p.n_del}" percent="{p.n_del * 0.5 / aln_len:.2f}" />',
        (
            f'<nMismatch value="{p.n_mismatch}" '
            f'percent="{p.n_mismatch * 0.5 / aln_len:.2f}" />'
        ),
        f'<nCorrect value="{p.n_match}" percent="{p.n_match * 0.5 / aln_len:.2f}" />',
        "<alignment><query>",
        qstr,
        "</query><target>",
        tstr,
        "</target></alignment>",
        "</hit>",
    ]
    return "\n".join(lines)


def format_m3(rec: AlignmentRecord) -> str:
    """-m 3 VULGAR string (role of VulgarAlignmentPrinter.h CreateVulgarString).

    Reproduces the reference's block walk: simultaneous insertion+deletion
    between two match blocks is folded into the preceding M run (cGap), then
    a single D or I run is emitted.
    """
    p = rec.path
    assert p is not None
    runs = p.cigar_runs()
    if not runs:
        return ""
    # collapse to (M-len, tGap, qGap) block gaps like the reference's blocks
    blocks: list[int] = []
    gaps: list[tuple[int, int]] = []  # (tGap=del, qGap=ins) after each block
    cur_t = cur_q = 0
    for op, ln in runs:
        if op == "M":
            blocks.append(ln)
            gaps.append((0, 0))
        elif not blocks:
            continue  # leading gap outside any block: reference has none
        elif op == "D":
            t, q = gaps[-1]
            gaps[-1] = (t + ln, q)
        else:
            t, q = gaps[-1]
            gaps[-1] = (t, q + ln)
    # fold simultaneous ins+del into the preceding M run: min(t, q) base
    # pairs align (possibly mismatching), the remainder is one-sided.
    # (The reference's cGap=abs(t-q) arithmetic drops bases when both gaps
    # are nonzero; we emit the consistent encoding instead.)
    out: list[str] = []
    for b in range(len(blocks) - 1):
        t_gap, q_gap = gaps[b]
        c_gap = min(t_gap, q_gap)
        t_gap -= c_gap
        q_gap -= c_gap
        out.append(f" M {blocks[b] + c_gap}")
        if t_gap > 0:
            out.append(f" D {t_gap}")
        elif q_gap > 0:
            out.append(f" I {q_gap}")
    out.append(f" M {blocks[-1]}")
    return "".join(out)
