"""BAM container round trip: BGZF layer, header, records, tags."""

import numpy as np

from blasr_jax.io.bam import (
    BGZF_EOF, bgzf_decompress, read_bam, write_bam_from_sam_lines,
)


HEADER = [
    "@HD\tVN:1.5",
    "@SQ\tSN:chr1\tLN:5000",
    "@SQ\tSN:chr2\tLN:3000",
    "@PG\tID:blasr_jax\tCL:test",
]
RECORDS = [
    "r1\t0\tchr1\t101\t60\t10S40M2I30M5D20M\t*\t0\t0\t"
    + "ACGT" * 25 + "AC\t" + "I" * 102
    + "\tRG:Z:abc\tAS:i:-371\tzm:i:-1\trq:f:0\tsn:B:f,0,0,0,0",
    "r2\t16\tchr2\t7\t254\t50M\t*\t0\t0\t" + "GATTACA" * 7 + "G\t*"
    + "\tNM:i:3\tXT:i:1",
    "u1\t4\t*\t0\t0\t*\t*\t0\t0\tACGTACGT\t*\tRG:Z:abc",
]


def test_bam_roundtrip(tmp_path):
    p = str(tmp_path / "a.bam")
    n = write_bam_from_sam_lines(HEADER, RECORDS, p)
    assert n == 3
    # EOF marker present
    raw = open(p, "rb").read()
    assert raw.endswith(BGZF_EOF)
    header, recs = read_bam(p)
    assert header == HEADER
    assert len(recs) == 3
    for orig, got in zip(RECORDS, recs):
        of = orig.split("\t")
        assert got[0] == of[0] and got[1] == of[1] and got[2] == of[2]
        assert got[3] == of[3] and got[4] == of[4] and got[5] == of[5]
        assert got[9] == of[9] and got[10] == of[10]
        assert sorted(got[11:]) == sorted(of[11:])


def test_bam_through_sam_reader(tmp_path):
    from blasr_jax.io.sam import read_sam

    p = str(tmp_path / "b.bam")
    write_bam_from_sam_lines(HEADER, RECORDS, p)
    sam = read_sam(p)
    assert sam.ref_lengths == {"chr1": 5000, "chr2": 3000}
    assert len(sam.records) == 3
    assert sam.records[0].qname == "r1"
    assert sam.records[0].tags["AS"] == "-371"
    assert sam.records[1].is_reverse


def test_large_block_spill(tmp_path):
    """Payload larger than one BGZF block splits into multiple members."""
    recs = [
        f"q{i}\t0\tchr1\t1\t60\t100M\t*\t0\t0\t" + "A" * 100 + "\t" + "I" * 100
        for i in range(3000)
    ]
    p = str(tmp_path / "big.bam")
    write_bam_from_sam_lines(HEADER, recs, p)
    data = bgzf_decompress(p)
    _, got = read_bam(p)
    assert len(got) == 3000


def test_cli_bam_output(tmp_path):
    """blasr -sam -out x.bam produces a BAM whose records equal the SAM."""
    import io as _io

    import numpy as np

    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.batching import Read
    from blasr_jax.io.seqdb import SeqDB
    from blasr_jax.output.sam_writer import write_sam
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping
    from blasr_jax.sim import simulate_genome, simulate_reads

    g = simulate_genome(40_000, seed=61, repeat_fraction=0.0)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    index = build_index_from_arrays(g, seqdb, k=13)
    reads, _ = simulate_reads(g, 8, mean_len=400, seed=62)
    params = MappingParams(batch_size=8, max_read_len=1024, n_candidates=2,
                           best_n=1, min_match_length=13)
    recs, unm = run_mapping(index, reads, params)
    buf = _io.StringIO()
    write_sam(recs, reads, seqdb, buf, unmapped=unm, genome=g)
    lines = buf.getvalue().split("\n")
    hdr = [l for l in lines if l.startswith("@")]
    body = [l for l in lines if l and not l.startswith("@")]
    p = str(tmp_path / "o.bam")
    write_bam_from_sam_lines(hdr, body, p)
    h2, r2 = read_bam(p)
    assert h2 == hdr and len(r2) == len(body)
    for orig, got in zip(body, r2):
        of = orig.split("\t")
        assert got[:6] == of[:6]
        assert got[9] == of[9]


def test_samtom4_reads_bam(tmp_path, capsys):
    """Satellite tools consume .bam through the shared read_sam dispatch."""
    from blasr_jax.cli.tools import main as tools_main

    p = str(tmp_path / "c.bam")
    write_bam_from_sam_lines(HEADER, RECORDS, p)
    assert tools_main(["samtom4", p]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 2  # two mapped records (u1 unmapped skipped)
    assert out[0].split()[0] == "r1" and out[0].split()[1] == "chr1"
