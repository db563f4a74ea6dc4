"""-m 4 interval output (L6).

Role of reference ``printers/IntervalAlignmentPrinter.h`` — the
machine-parsable 13-column format:

qname tname score pctsimilarity qstrand qstart qend qseqlength tstrand
tstart tend tseqlength mapqv
"""

from __future__ import annotations

from typing import IO, Iterable

from blasr_jax.pipeline.runner import AlignmentRecord

HEADER = (
    "qname tname score pctsimilarity qstrand qstart qend qseqlength "
    "tstrand tstart tend tseqlength mapqv"
)


def ref_qname(name: str, qlength: int) -> str:
    """Reference qname convention: whole reads print as <title>/0_<len>
    (SMRTSequence subread naming; observed on every blasrmc output format).
    Names that already carry a /qs_qe subread suffix pass through."""
    base, _, tail = name.rpartition("/")
    if base and "_" in tail:
        a, _, b = tail.partition("_")
        if a.isdigit() and b.isdigit():
            return name
    return f"{name}/0_{qlength}"


def format_m4(rec: AlignmentRecord) -> str:
    return (
        f"{ref_qname(rec.qname, rec.qlength)} {rec.tname} {rec.score} "
        f"{rec.pct_similarity:.4f} "
        f"{rec.qstrand} {rec.qstart} {rec.qend} {rec.qlength} "
        f"{rec.tstrand} {rec.tstart} {rec.tend} {rec.tlength} {rec.mapqv}"
    )


def write_m4(records: Iterable[AlignmentRecord], out: IO[str], header: bool = False) -> None:
    if header:
        out.write(HEADER + "\n")
    for rec in records:
        out.write(format_m4(rec) + "\n")
