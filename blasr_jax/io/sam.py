"""SAM reading (L1) + SAM-record utilities for satellite tools.

Role of reference ``common/algorithms/alignment/readers/sam/SAMReader.h``
(header + alignment-line parsing into typed records) and the
``SAMAlignment``/``SAMToSMRTSequence`` object model in
``common/datastructures/alignmentset/`` — re-designed as a flat numpy/
dataclass parse (no template machinery needed host-side).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

from blasr_jax.core.encode import revcomp_codes, seq_to_codes

_CIGAR_RE = re.compile(rb"(\d+)([MIDNSHP=X])")


@dataclasses.dataclass
class SAMRecord:
    qname: str
    flag: int
    rname: str
    pos: int                     # 1-based leftmost mapping position
    mapq: int
    cigar: str
    seq: str
    qual: Optional[np.ndarray]   # phred values or None
    tags: dict[str, str]

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & 4)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 16)

    def cigar_runs(self) -> list[tuple[str, int]]:
        return [
            (op.decode(), int(n))
            for n, op in _CIGAR_RE.findall(self.cigar.encode())
        ]

    def aligned_lengths(self) -> tuple[int, int, int, int]:
        """(qstart, qend, tlen_consumed, qlen) from the CIGAR."""
        qpos = 0
        qstart = None
        tlen = 0
        for op, n in self.cigar_runs():
            if op in "SH":
                if qstart is None and op == "S":
                    qpos += n
                continue
            if op in "M=X":
                if qstart is None:
                    qstart = qpos
                qpos += n
                tlen += n
            elif op == "I":
                if qstart is None:
                    qstart = qpos
                qpos += n
            elif op in "DN":
                tlen += n
        qlen = len(self.seq) if self.seq != "*" else qpos
        # hard clips extend the original read beyond SEQ
        hard = sum(n for op, n in self.cigar_runs() if op == "H")
        return (qstart or 0, qpos, tlen, qlen + hard)


@dataclasses.dataclass
class SAMFile:
    header_lines: list[str]
    records: list[SAMRecord]

    @property
    def ref_lengths(self) -> dict[str, int]:
        out = {}
        for line in self.header_lines:
            if line.startswith("@SQ"):
                name = ln = None
                for fld in line.split("\t")[1:]:
                    if fld.startswith("SN:"):
                        name = fld[3:]
                    elif fld.startswith("LN:"):
                        ln = int(fld[3:])
                if name is not None and ln is not None:
                    out[name] = ln
        return out


def _fields_to_record(fields: list[str]) -> SAMRecord:
    tags = {}
    for t in fields[11:]:
        parts = t.split(":", 2)
        if len(parts) == 3:
            tags[parts[0]] = parts[2]
    qual = None
    if fields[10] != "*":
        qual = np.frombuffer(fields[10].encode(), np.uint8) - 33
    return SAMRecord(
        qname=fields[0], flag=int(fields[1]), rname=fields[2],
        pos=int(fields[3]), mapq=int(fields[4]), cigar=fields[5],
        seq=fields[9], qual=qual, tags=tags,
    )


def read_sam(path: str) -> SAMFile:
    if path.endswith(".bam"):
        from blasr_jax.io.bam import read_bam

        header, recs = read_bam(path)
        return SAMFile(header, [_fields_to_record(f) for f in recs])
    header: list[str] = []
    records: list[SAMRecord] = []
    opener = (
        (lambda p: __import__("gzip").open(p, "rt"))
        if path.endswith(".gz") else (lambda p: open(p, "r"))
    )
    with opener(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("@"):
                header.append(line)
                continue
            fields = line.split("\t")
            if len(fields) < 11:
                continue
            records.append(_fields_to_record(fields))
    return SAMFile(header, records)


def sam_records_to_reads(sam: SAMFile):
    """SAM -> Read list for re-mapping (role of SAMToSMRTSequence: recover
    the original read orientation from FLAG 16)."""
    from blasr_jax.io.batching import Read

    out = []
    seen: set[str] = set()
    for i, rec in enumerate(sam.records):
        if rec.flag & 0x900:  # secondary/supplementary: not the full read
            continue
        if rec.qname in seen or rec.seq == "*":
            continue
        seen.add(rec.qname)
        codes = seq_to_codes(rec.seq.encode())
        qual = rec.qual
        # supplemental QV tracks (samqv tags, SAMAlignment.h:280-296 /
        # SAMSupplementalQVList.h): iq/dq/sq/mq are phred+33 strings,
        # st/dt nucleotide strings; restore read orientation with the seq
        qvs = {}
        for tag in ("iq", "dq", "sq", "mq"):
            v = rec.tags.get(tag)
            if v is not None and len(v) == len(codes):
                qvs[tag] = np.frombuffer(v.encode(), np.uint8) - 33
        for tag in ("st", "dt"):
            v = rec.tags.get(tag)
            if v is not None and len(v) == len(codes):
                qvs[tag] = seq_to_codes(v.encode())
        if rec.is_reverse:
            codes = revcomp_codes(codes)
            qual = qual[::-1].copy() if qual is not None else None
            for tag in ("iq", "dq", "sq", "mq"):
                if tag in qvs:
                    qvs[tag] = qvs[tag][::-1].copy()
            for tag in ("st", "dt"):
                if tag in qvs:
                    qvs[tag] = revcomp_codes(qvs[tag])
        # strip a whole-read /0_<len> suffix (the reference's SMRTSequence
        # naming, re-appended on output) so round-trips are stable
        name = rec.qname
        base, _, tail = name.rpartition("/")
        if base and tail.startswith("0_") and tail[2:].isdigit() and int(tail[2:]) == len(codes):
            name = base
        out.append(Read(name, codes, qual, len(out), qvs=qvs or None))
    return out
