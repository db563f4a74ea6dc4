"""Read batching: ragged host reads -> fixed-shape device batches (L1).

Role of reference ``common/files/ReaderAgglomerate.h`` (:21-399 — the
format-dispatching shared reader that feeds one read at a time to each
pthread). The device design replaces the semaphore-guarded single-read stream
with length-bucketed, padded (B, L) uint8 batches: all irregularity is
resolved on the host so the device only ever sees static shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np

from blasr_jax.core.encode import CODE_N
from blasr_jax.io.fasta import read_fasta
from blasr_jax.io.fastq import read_fastq


@dataclasses.dataclass
class Read:
    name: str
    codes: np.ndarray            # uint8 [n]
    qual: Optional[np.ndarray] = None  # uint8 [n] phred, or None (FASTA)
    index: int = -1              # position in the input stream
    # supplemental QV tracks (the samqv set, SAMSupplementalQVList.h:7-9):
    # 'iq' 'dq' 'sq' 'mq' -> uint8 phred arrays, 'st' 'dt' -> uint8 base
    # codes; populated from SAM optional fields, echoed back on SAM output
    qvs: Optional[dict] = None

    def __len__(self) -> int:
        return len(self.codes)


@dataclasses.dataclass
class ReadBatch:
    """A padded batch of reads.

    codes: uint8 [B, L] padded with CODE_N
    lengths: int32 [B]
    names: list[str] length B (padding rows get name "")
    indices: int32 [B] original stream indices (-1 for padding rows)
    qual: optional uint8 [B, L]
    """

    codes: np.ndarray
    lengths: np.ndarray
    names: list[str]
    indices: np.ndarray
    qual: Optional[np.ndarray] = None

    @property
    def batch_size(self) -> int:
        return self.codes.shape[0]

    @property
    def max_len(self) -> int:
        return self.codes.shape[1]


def read_records(path: str, fmt: Optional[str] = None) -> list[Read]:
    """Load reads from FASTA/FASTQ, dispatching on extension like the
    reference BaseSequenceIO (common/files/BaseSequenceIO.h). A ``.fofn``
    file-of-filenames expands to the concatenation of its entries with a
    single global stream index (common/utils/FileOfFileNames.h:11-31)."""
    if fmt is None and path.lower().endswith(".fofn"):
        import os

        base = os.path.dirname(os.path.abspath(path))
        reads: list[Read] = []
        with open(path) as f:
            for line in f:
                name = line.strip()
                if not name:
                    continue
                sub = name if os.path.isabs(name) else os.path.join(base, name)
                for r in read_records(sub):
                    r.index = len(reads)
                    reads.append(r)
        return reads
    if fmt is None:
        low = path.lower()
        if low.endswith(".gz"):
            low = low[:-3]  # transparent gzip (modern convenience the
            #                 reference lacks; readers open via gzip)
        if low.endswith((".fq", ".fastq")):
            fmt = "fastq"
        elif low.endswith((".fa", ".fasta", ".fsta", ".fna")):
            fmt = "fasta"
        elif low.endswith((".sam", ".bam")):
            fmt = "sam"
        else:
            # sniff first byte
            opener = __import__("gzip").open if path.endswith(".gz") else open
            with opener(path, "rb") as f:
                first = f.read(1)
            fmt = "fastq" if first == b"@" else "fasta"
    if fmt == "sam":
        from blasr_jax.io.sam import read_sam, sam_records_to_reads

        return sam_records_to_reads(read_sam(path))
    if fmt == "fastq":
        return [
            Read(name, codes, qual, i)
            for i, (name, codes, qual) in enumerate(read_fastq(path))
        ]
    return [Read(name, codes, None, i) for i, (name, codes) in enumerate(read_fasta(path))]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def batch_reads(
    reads: Sequence[Read],
    batch_size: int,
    max_read_len: int,
    length_buckets: Sequence[int] = (
        # 256-step buckets through the PacBio body of the length
        # distribution: DP/anchor cost scales ~linearly with the pad
        # bound, so fine buckets cut the padding tax on reads just over a
        # power of two (a 1100 b read costs 1280-pad, not 2048-pad).
        # Each bucket compiles once (persistent XLA cache).
        256, 512, 768, 1024, 1280, 1536, 1792, 2048, 2560, 3072,
        4096, 6144, 8192,
    ),
    subsample: float = 1.0,
    stride: int = 1,
    start: int = 0,
    seed: int = 0,
) -> Iterator[ReadBatch]:
    """Bucket reads by length and yield padded batches.

    Reads longer than max_read_len are truncated (the long-read piecewise
    path handles them separately in later rounds). ``stride``/``start``/
    ``subsample`` mirror the reference's process-level input sharding flags
    (-stride/-start/-subsample, ReaderAgglomerate.h:81-95).
    """
    rng = np.random.default_rng(seed)
    chosen = [
        r
        for i, r in enumerate(reads)
        if i >= start and (i - start) % stride == 0
        and (subsample >= 1.0 or rng.random() < subsample)
    ]
    buckets: dict[int, list[Read]] = {}
    caps = sorted(set(min(b, max_read_len) for b in length_buckets if b > 0))
    if not caps or caps[-1] < max_read_len:
        caps.append(max_read_len)
    for r in chosen:
        n = min(len(r), max_read_len)
        cap = next(c for c in caps if n <= c)
        buckets.setdefault(cap, []).append(r)

    # straggler spill-up: a bucket's final partial chunk joins the next
    # bucket's group (paying a wider pad) when that trades less device time
    # than a mostly-empty batch — every row of a batch computes regardless
    # of fill, so fill factor beats pad width for small remainders.
    order = sorted(buckets)
    for ci, cap in enumerate(order[:-1]):
        group = buckets[cap]
        rem = len(group) % batch_size
        if rem == 0:
            continue
        nxt = order[ci + 1]
        # cost of one extra batch at this cap vs the spilled rows padding
        # up to the next cap (cell model: per-batch ~ (2*cap + pad) * B)
        if rem * (2 * nxt + 256) < batch_size * (2 * cap + 256):
            buckets[nxt].extend(group[len(group) - rem :])
            del group[len(group) - rem :]
            if not group:
                del buckets[cap]

    for cap in sorted(buckets):
        group = buckets[cap]
        has_qual = any(r.qual is not None for r in group)
        # IDS scoring (IDSScoreFunction.h role): when supplemental samqv
        # tracks are present, the batch carries TWO phred streams packed in
        # uint16 — low byte scales mismatches (sq, falling back to the
        # primary qual), high byte scales insertions (iq) — which the DP
        # kernels unpack per cell
        has_ids = any(
            r.qvs is not None and ("sq" in r.qvs or "iq" in r.qvs)
            for r in group
        )
        for ofs in range(0, len(group), batch_size):
            chunk = group[ofs : ofs + batch_size]
            b = len(chunk)
            codes = np.full((batch_size, cap), CODE_N, dtype=np.uint8)
            lengths = np.zeros(batch_size, dtype=np.int32)
            indices = np.full(batch_size, -1, dtype=np.int32)
            names = [""] * batch_size
            # neutral phred 15 (= unscaled penalties) for rows/reads
            # without quality values in a mixed batch
            if has_ids:
                qual = np.full(
                    (batch_size, cap), 15 | (15 << 8), dtype=np.uint16
                )
            elif has_qual:
                qual = np.full((batch_size, cap), 15, dtype=np.uint8)
            else:
                qual = None
            for j, r in enumerate(chunk):
                n = min(len(r), cap)
                codes[j, :n] = r.codes[:n]
                lengths[j] = n
                indices[j] = r.index
                names[j] = r.name
                if qual is None:
                    continue
                base = r.qual[:n] if r.qual is not None else np.full(n, 15, np.uint8)
                if has_ids:
                    qvs = r.qvs or {}
                    sub = qvs.get("sq")
                    ins = qvs.get("iq")
                    sub = sub[:n] if sub is not None else base
                    ins = ins[:n] if ins is not None else base
                    qual[j, :n] = sub.astype(np.uint16) | (
                        ins.astype(np.uint16) << 8
                    )
                elif r.qual is not None:
                    qual[j, :n] = base
            yield ReadBatch(codes, lengths, names, indices, qual)
