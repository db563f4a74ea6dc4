import io
import re

import numpy as np
import pytest

from blasr_jax.core.encode import revcomp_codes
from blasr_jax.index.artifacts import build_index_from_arrays
from blasr_jax.io.batching import Read
from blasr_jax.io.seqdb import SeqDB
from blasr_jax.params import MappingParams
from blasr_jax.pipeline.runner import run_mapping
from tests.conftest import mutate_read


@pytest.fixture(scope="module")
def mapped():
    rng = np.random.default_rng(9)
    G = 60_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    seqdb = SeqDB(["ctg1"], np.array([0, G], dtype=np.int64), ["a" * 32])
    index = build_index_from_arrays(genome, seqdb, k=14)
    reads = []
    for i in range(6):
        start = 1000 + i * 5000
        r = mutate_read(rng, genome, start, 600)
        if i % 2:
            r = revcomp_codes(r)
        qual = rng.integers(10, 40, len(r)).astype(np.uint8)
        reads.append(Read(f"r{i}", r, qual, i))
    params = MappingParams(batch_size=8, max_read_len=1024, n_candidates=4, best_n=1)
    records, unmapped = run_mapping(index, reads, params)
    return index, reads, records, unmapped


CIGAR_RE = re.compile(r"(\d+)([MIDSH])")


def test_sam_output_valid(mapped):
    from blasr_jax.output.sam_writer import write_sam

    index, reads, records, unmapped = mapped
    assert len(records) == 6
    buf = io.StringIO()
    write_sam(records, reads, index.seqdb, buf, unmapped=unmapped)
    lines = buf.getvalue().strip().split("\n")
    hdr = [l for l in lines if l.startswith("@")]
    body = [l for l in lines if not l.startswith("@")]
    assert any(l.startswith("@SQ") and "SN:ctg1" in l and "LN:60000" in l for l in hdr)
    assert len(body) == 6
    for l in body:
        f = l.split("\t")
        assert len(f) >= 11
        flag = int(f[1])
        assert flag in (0, 16)
        pos = int(f[3])
        assert 1 <= pos <= 60000
        cigar = f[5]
        seq = f[9]
        qual = f[10]
        assert len(seq) == len(qual)
        # CIGAR query-consuming ops must sum to SEQ length
        qsum = sum(int(n) for n, op in CIGAR_RE.findall(cigar) if op in "MIS")
        assert qsum == len(seq), (cigar, len(seq))
        # reference span check: M+D from POS stays in contig
        tsum = sum(int(n) for n, op in CIGAR_RE.findall(cigar) if op in "MD")
        assert pos + tsum - 1 <= 60000


def test_sam_seq_matches_reference_orientation(mapped):
    """Aligned M-run bases in SEQ must mostly equal the reference bases."""
    from blasr_jax.output.sam_writer import write_sam
    from blasr_jax.core.encode import codes_to_seq

    index, reads, records, unmapped = mapped
    buf = io.StringIO()
    write_sam(records, reads, index.seqdb, buf)
    genome_str = codes_to_seq(index.genome)
    for l in buf.getvalue().strip().split("\n"):
        if l.startswith("@"):
            continue
        f = l.split("\t")
        pos, cigar, seq = int(f[3]) - 1, f[5], f[9]
        qi, ti = 0, pos
        match, total = 0, 0
        for n, op in CIGAR_RE.findall(cigar):
            n = int(n)
            if op == "S":
                qi += n
            elif op == "M":
                for j in range(n):
                    total += 1
                    if seq[qi + j] == genome_str[ti + j]:
                        match += 1
                qi += n
                ti += n
            elif op == "I":
                qi += n
            elif op == "D":
                ti += n
        assert total > 0 and match / total > 0.85, f"M-run identity {match}/{total}"


def test_m5_m1_m0_formats(mapped):
    from blasr_jax.output.verbose import format_m0, format_m1, format_m5

    index, reads, records, _ = mapped
    by_name = {r.name: r for r in reads}
    for rec in records[:3]:
        rd = by_name[rec.qname]
        m5 = format_m5(rec, rd, index).split()
        assert len(m5) == 19
        qstr, mstr, tstr = m5[16], m5[17], m5[18]
        assert len(qstr) == len(mstr) == len(tstr)
        assert qstr.replace("-", "") != ""
        # matched columns really match
        n_bar = mstr.count("|")
        assert n_bar == rec.path.n_match
        m1 = format_m1(rec).split()
        assert len(m1) == 13
        m0 = format_m0(rec, rd, index)
        assert "nMatch:" in m0 and "QueryRange:" in m0 and "q: " in m0
