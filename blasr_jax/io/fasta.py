"""FASTA reading/writing (L1).

Role of reference ``common/FASTAReader.h`` (buffered parse,
``ReadAllSequencesIntoOne`` used at Blasr.cpp:4316-4338), re-designed as a
whole-file vectorized numpy parse: one read of the file, newline split, and
bulk concatenation — no per-character loop.
"""

from __future__ import annotations

import hashlib
from typing import Iterator

import numpy as np

from blasr_jax.core.encode import codes_to_seq, seq_to_codes


def read_fasta(path: str) -> list[tuple[str, np.ndarray]]:
    """Parse FASTA -> list of (name, codes uint8[n]).

    Name is the first whitespace-delimited token of the title line
    (matching reference FASTASequence::GetName()).
    """
    from blasr_jax import native

    opener = __import__("gzip").open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    use_native = native.available()
    records: list[tuple[str, np.ndarray]] = []

    def encode(body: bytes) -> np.ndarray:
        if use_native:
            out = native.encode_strip(body)
            if out is not None:
                return out
        return seq_to_codes(b"".join(body.split()))

    # split on headers; the native encoder strips newlines/whitespace itself
    pos = data.find(b">")
    while pos >= 0:
        eol = data.find(b"\n", pos)
        if eol < 0:
            eol = len(data)
        title = data[pos + 1 : eol].strip()
        name = title.split()[0].decode("ascii") if title else ""
        nxt = data.find(b"\n>", eol)
        body_end = len(data) if nxt < 0 else nxt + 1
        records.append((name, encode(data[eol + 1 : body_end])))
        pos = -1 if nxt < 0 else nxt + 1
    return records


def write_fasta(path: str, records: list[tuple[str, np.ndarray]], width: int = 70) -> None:
    with open(path, "w") as f:
        for name, codes in records:
            f.write(f">{name}\n")
            s = codes_to_seq(codes)
            for i in range(0, len(s), width):
                f.write(s[i : i + width] + "\n")


def iter_fasta(path: str) -> Iterator[tuple[str, np.ndarray]]:
    yield from read_fasta(path)


def md5_of_codes(codes: np.ndarray) -> str:
    """MD5 of the uppercase ASCII sequence (for SAM @SQ M5 tags; role of
    reference FASTAReader computeMD5 / MakeMD5 in common/utils.h)."""
    return hashlib.md5(codes_to_seq(codes).encode("ascii")).hexdigest()
