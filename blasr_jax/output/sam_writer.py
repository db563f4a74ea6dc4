"""SAM output (L6).

Role of reference ``printers/SAMPrinter.h`` (flag building :30-51, clipping
modes :59-102, CIGAR emission with X/= ops :120-260, PrintAlignment tag set
:419-545) and the header emission in main() (Blasr.cpp:4628-4700 @RG per
movie, MakeSAMHDString/MakeSAMPGString Blasr.cpp:284-297).

Reference conventions reproduced here:
  - For FASTA/FASTQ input the "movie name" is the input FILE NAME
    (ReaderAgglomerate.h:119-126) and the read-group id is the first 10 hex
    chars of its MD5 (ReaderAgglomerate.h:209-211).
  - CIGAR match blocks are split into X (mismatch) and = (match) runs
    (SAMPrinter.h AddUngappedOperations); clips are S (soft) or H (hard).
  - RNEXT/PNEXT are always */0 (SAMPrinter.h:455-462 prints literal values);
    TLEN is the genomic span (SAMPrinter.h:464-466).
  - SEQ is reverse-complemented when FLAG 16 is set.
"""

from __future__ import annotations

import hashlib
from typing import IO, Iterable, Optional, Sequence

import numpy as np

from blasr_jax.core.encode import codes_to_seq, revcomp_codes
from blasr_jax.io.batching import Read
from blasr_jax.io.seqdb import SeqDB
from blasr_jax.pipeline.runner import AlignmentRecord

FLAG_UNMAPPED = 4
FLAG_REVERSE = 16
FLAG_SECONDARY = 256

OP_M, OP_I, OP_D = 1, 2, 3


def read_group_id(movie_name: str) -> str:
    """First 10 hex chars of MD5(movie) — ReaderAgglomerate.h:211."""
    return hashlib.md5(movie_name.encode()).hexdigest()[:10]


def chip_id_of(movie_name: str) -> str:
    """Tokenize movie on '_': 1 field -> itself, >4 -> field 3, else
    NO_CHIP_ID (Blasr.cpp:299-311 ParseChipIdFromMovieName)."""
    fields = movie_name.split("_")
    if len(fields) == 1:
        return fields[0]
    if len(fields) > 4:
        return fields[3]
    return "NO_CHIP_ID"


def sam_header(
    seqdb: SeqDB,
    program_line: str = "blasr_jax",
    movie_names: Sequence[str] = ("default",),
) -> list[str]:
    lines = ["@HD\tVN:1.5\tpb:3.0.1"]
    seen = set()
    for movie in movie_names:
        if movie in seen:
            continue
        seen.add(movie)
        lines.append(
            (
                "\t".join(("@RG", "ID:{}", "PU:{}", "SM:{}", "PL:PACBIO", ""))
                + "DS:READTYPE=SUBREAD;"
                "CHANGELISTID=;BINDINGKIT=;SEQUENCINGKIT=;FRAMERATEHZ=100;"
                "BASECALLERVERSION=;InsertionQV=iq;DeletionQV=dq;"
                "SubstitutionQV=sq;MergeQV=mq;SubstitutionTag=st;"
                "DeletionTag=dt;Ipd=ip"
            ).format(
                read_group_id(movie), movie, chip_id_of(movie)
            )
        )
    lines.extend(seqdb.sam_sq_lines())
    lines.append(f"@PG\tID:blasr_jax\tPN:blasr_jax\tVN:2.0\tCL:{program_line}")
    return lines


def _xeq_runs(
    ops: np.ndarray, q_aln: np.ndarray, t_aln: np.ndarray,
    q_start: int, t_start: int,
) -> list[tuple[int, str]]:
    """RLE cigar ops with M split into =/X by base comparison
    (SAMPrinter.h AddUngappedOperations).

    q_aln: query codes in ALIGNED orientation; t_aln: forward target window
    codes; starts are the path-local span starts into those arrays.
    """
    if ops.size == 0:
        return []
    qstep = (ops != OP_D).astype(np.int64)
    tstep = (ops != OP_I).astype(np.int64)
    qpos = q_start + np.cumsum(qstep) - qstep
    tpos = t_start + np.cumsum(tstep) - tstep
    ism = ops == OP_M
    match = np.zeros(ops.size, bool)
    match[ism] = q_aln[qpos[ism]] == t_aln[tpos[ism]]
    # symbol per op: '=' match, 'X' mismatch, 'I', 'D'
    sym = np.where(ops == OP_I, 0, np.where(ops == OP_D, 1, np.where(match, 2, 3)))
    chars = "ID=X"
    ends = np.flatnonzero(np.diff(sym)) + 1
    bounds = np.concatenate(([0], ends, [sym.size]))
    return [
        (int(bounds[i + 1] - bounds[i]), chars[int(sym[bounds[i]])])
        for i in range(len(bounds) - 1)
    ]


def _cigar_string(
    rec: AlignmentRecord,
    read_len: int,
    clipping: str,
    q_aln: np.ndarray | None,
    t_aln: np.ndarray | None,
) -> str:
    path = rec.path
    assert path is not None
    pre = path.q_start
    post = read_len - path.q_end
    # "subread" clips to the subread region (SAMPrinter.h:81-84); without
    # region tables (HDF5-only) the subread IS the whole read, so it
    # behaves as soft clipping here
    clip_op = "S" if clipping in ("soft", "subread") else "H"
    ops = np.asarray(path.ops)
    if q_aln is not None and t_aln is not None:
        from blasr_jax import native

        clipped = clipping != "none"
        s = native.xeq_cigar(
            ops, q_aln, t_aln, path.q_start, path.t_start,
            pre if clipped else 0, post if clipped else 0, clip_op,
        )
        if s is not None:
            return s
    parts = []
    if pre and clipping != "none":
        parts.append(f"{pre}{clip_op}")
    if q_aln is not None and t_aln is not None:
        runs = _xeq_runs(ops, q_aln, t_aln, path.q_start, path.t_start)
        parts.extend(f"{ln}{op}" for ln, op in runs)
    else:
        parts.extend(f"{ln}{op}" for op, ln in path.cigar_runs())
    if post and clipping != "none":
        parts.append(f"{post}{clip_op}")
    return "".join(parts)


def _parse_zmw(name: str) -> int:
    """PacBio read names are movie/holeNumber/qs_qe; return holeNumber, or
    -1 like the reference's unset SMRTSequence.holeNumber for FASTA input."""
    parts = name.split("/")
    if len(parts) >= 2 and parts[1].isdigit():
        return int(parts[1])
    return -1


def format_sam_record(
    rec: AlignmentRecord,
    read: Read,
    clipping: str = "soft",
    rgid: str = "default",
    genome: np.ndarray | None = None,
    genome_start: int = 0,
    is_primary: bool = True,
    samqv: tuple | None = None,
) -> str:
    n = len(read.codes)
    flag = FLAG_REVERSE if rec.tstrand else 0
    if not is_primary:
        flag |= FLAG_SECONDARY
    pos = rec.tstart_fwd + 1  # 1-based
    p = rec.path
    t_aln = None
    if genome is not None:
        # forward-genome window positioned so that path-local t coords index
        # it directly (t_start maps to contig-forward tstart_fwd)
        w0 = genome_start + rec.tstart_fwd - p.t_start
        lo = max(w0, 0)
        t_aln = genome[lo : w0 + p.t_end]
        if w0 < 0:  # window head clipped; pad to keep local indexing
            t_aln = np.concatenate([np.full(-w0, 5, np.uint8), t_aln])
    fields3 = None
    if t_aln is not None and getattr(p, "packed", None) is not None:
        # hot path: ONE native pass over the packed walk output produces
        # CIGAR + SEQ + QUAL (orientation, clipping, =/X splitting all in C)
        from blasr_jax import native

        fields3 = native.sam_fields(
            p.packed, p.packed_nops, p.q_start, p.t_start,
            read.codes, read.qual, t_aln, rec.tstrand,
            0 if clipping == "none" else (2 if clipping == "hard" else 1),
            "S" if clipping in ("soft", "subread") else "H",
        )
    if fields3 is not None:
        cigar, seq, qual_s = fields3
    else:
        codes = read.codes if rec.tstrand == 0 else revcomp_codes(read.codes)
        qual = read.qual
        if qual is not None and rec.tstrand == 1:
            qual = qual[::-1]
        cigar = _cigar_string(
            rec, n, clipping, codes if t_aln is not None else None, t_aln
        )
        if clipping == "hard":
            codes = codes[p.q_start : p.q_end]
            if qual is not None:
                qual = qual[p.q_start : p.q_end]
        seq = codes_to_seq(codes)
        qual_s = (
            "*" if qual is None
            else (np.asarray(qual) + 33).astype(np.uint8).tobytes().decode()
        )
    # XS/XE are the HARD-clip bounds + 1, not the aligned span
    # (SAMPrinter.h:506-520: xs = prefixHardClip + 1, xe = len - suffix + 1);
    # with soft clipping and no low-quality regions that is 1 .. len+1.
    if clipping == "hard":
        xs = (p.q_start if rec.tstrand == 0 else n - p.q_end) + 1
        xe = (p.q_end if rec.tstrand == 0 else n - p.q_start) + 1
    elif clipping == "none":
        xs, xe = p.q_start + 1, p.q_end + 1
    else:
        xs, xe = 1, n + 1
    # NM is the real edit distance here; the reference leaves context.editDist
    # at 0 for FASTA input (observed: NM:i:0 on every record) — a bug we do
    # not reproduce.
    nm = p.n_mismatch + p.n_ins + p.n_del
    tags = [
        f"RG:Z:{rgid}",
        f"AS:i:{rec.score}",
        f"XS:i:{xs}",
        f"XE:i:{xe}",
    ]
    if clipping in ("soft", "subread", "hard"):
        # read.qs/qe (SMRTSequence subread bounds; 1..len+1 for whole reads)
        tags += [f"qs:i:{1}", f"qe:i:{n + 1}"]
    if read.qvs:
        # echo supplemental QV tracks (SAMPrinter.h:534-549 /
        # SAMSupplementalQVList::PrintQVOptionalFields): oriented with the
        # emitted SEQ and clipped like it
        use = samqv if samqv is not None else ("iq", "dq", "sq", "mq", "st", "dt")
        for tag in use:
            tr = read.qvs.get(tag)
            if tr is None or len(tr) != n:
                continue
            if rec.tstrand == 1:
                tr = revcomp_codes(tr) if tag in ("st", "dt") else tr[::-1]
            if clipping == "hard":
                tr = tr[p.q_start : p.q_end]
            if tag in ("st", "dt"):
                tags.append(f"{tag}:Z:{codes_to_seq(tr)}")
            else:
                s = (np.minimum(np.asarray(tr), 93) + 33).astype(np.uint8)
                tags.append(f"{tag}:Z:{s.tobytes().decode()}")
    tags += [
        f"zm:i:{_parse_zmw(rec.qname)}",
        f"XL:i:{p.q_end - p.q_start}",
        "XT:i:1",
        f"NM:i:{nm}",
        f"FI:i:{p.q_start + 1}",
        f"XQ:i:{rec.qlength}",
        "rq:f:0",
        "np:i:0",
        "cx:i:0",
        "sn:B:f,0,0,0,0",
    ]
    from blasr_jax.output.m4 import ref_qname

    fields = [
        ref_qname(rec.qname, rec.qlength),
        str(flag),
        rec.tname,
        str(pos),
        str(rec.mapqv),
        cigar,
        "*",                                  # RNEXT (SAMPrinter.h:455)
        "0",                                  # PNEXT (SAMPrinter.h:459)
        str(rec.tend_fwd - rec.tstart_fwd),   # TLEN = genomic span (:464)
        seq,
        qual_s,
    ] + tags
    return "\t".join(fields)


def format_unmapped(read: Read, rgid: str = "default") -> str:
    qual_s = "*" if read.qual is None else (np.asarray(read.qual) + 33).astype(np.uint8).tobytes().decode()
    return "\t".join(
        [read.name, str(FLAG_UNMAPPED), "*", "0", "0", "*", "*", "0", "0",
         codes_to_seq(read.codes), qual_s, f"RG:Z:{rgid}"]
    )


def write_sam(
    records: Iterable[AlignmentRecord],
    reads: Sequence[Read],
    seqdb: SeqDB,
    out: IO[str],
    clipping: str = "soft",
    program_line: str = "blasr_jax",
    unmapped: Optional[Sequence[str]] = None,
    movie_name: str = "default",
    genome: np.ndarray | None = None,
    print_unmapped: bool = True,
    samqv: tuple | None = None,
) -> None:
    for line in sam_header(seqdb, program_line, [movie_name]):
        out.write(line + "\n")
    rgid = read_group_id(movie_name)
    # records keyed by read INDEX (duplicate read names are legal in FASTA;
    # keying by name would silently drop records)
    by_index: dict[int, list[AlignmentRecord]] = {}
    by_name: dict[str, int] = {}
    for i, r in enumerate(reads):
        by_name.setdefault(r.name, i)
    for rec in records:
        idx = rec.read_index
        if idx < 0 or idx >= len(reads):
            idx = by_name.get(rec.qname, -1)
            if idx < 0:
                continue
        by_index.setdefault(idx, []).append(rec)
    unmapped_set = set(unmapped or ())
    for idx, rd in enumerate(reads):
        recs = by_index.get(idx)
        if recs:
            best = min(range(len(recs)), key=lambda j: recs[j].score)
            for j, rec in enumerate(recs):
                out.write(
                    format_sam_record(
                        rec, rd, clipping, rgid=rgid, genome=genome,
                        genome_start=int(seqdb.starts[rec.contig_index])
                        if rec.contig_index >= 0 else 0,
                        is_primary=(j == best),
                        samqv=samqv,
                    )
                    + "\n"
                )
        elif print_unmapped and rd.name in unmapped_set:
            out.write(format_unmapped(rd, rgid=rgid) + "\n")
