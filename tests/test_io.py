import numpy as np

from blasr_jax.core.encode import codes_to_seq, seq_to_codes
from blasr_jax.io.batching import Read, batch_reads, read_records
from blasr_jax.io.fasta import read_fasta, write_fasta
from blasr_jax.io.fastq import read_fastq, write_fastq
from blasr_jax.io.seqdb import load_genome


def test_fasta_roundtrip(tmp_path):
    recs = [("chr1", seq_to_codes("ACGTACGTAC")), ("chr2 extra", seq_to_codes("GGGGCCCC"))]
    p = str(tmp_path / "t.fasta")
    write_fasta(p, recs, width=4)
    out = read_fasta(p)
    assert out[0][0] == "chr1"
    assert codes_to_seq(out[0][1]) == "ACGTACGTAC"
    assert out[1][0] == "chr2"  # name = first token
    assert codes_to_seq(out[1][1]) == "GGGGCCCC"


def test_fastq_roundtrip(tmp_path):
    qual = np.array([10, 20, 30, 40], dtype=np.uint8)
    recs = [("r1", seq_to_codes("ACGT"), qual)]
    p = str(tmp_path / "t.fastq")
    write_fastq(p, recs)
    out = read_fastq(p)
    assert out[0][0] == "r1"
    assert codes_to_seq(out[0][1]) == "ACGT"
    assert np.array_equal(out[0][2], qual)


def test_load_genome_concat(tmp_path):
    recs = [("a", seq_to_codes("ACGT")), ("b", seq_to_codes("TTTT"))]
    p = str(tmp_path / "g.fasta")
    write_fasta(p, recs)
    genome, seqdb = load_genome(p)
    assert len(genome) == 8
    assert seqdb.names == ["a", "b"]
    assert seqdb.starts.tolist() == [0, 4, 8]
    c, off = seqdb.to_local(np.array([0, 3, 4, 7]))
    assert c.tolist() == [0, 0, 1, 1]
    assert off.tolist() == [0, 3, 0, 3]


def test_batching_pads_and_buckets():
    rng = np.random.default_rng(0)
    reads = [
        Read(f"r{i}", rng.integers(0, 4, size=n).astype(np.uint8), None, i)
        for i, n in enumerate([100, 120, 500, 900, 2000])
    ]
    batches = list(batch_reads(reads, batch_size=4, max_read_len=2048,
                               length_buckets=(256, 1024, 2048)))
    # bucket caps: 256 (r0,r1); 1024 (r2,r3) — its 2-read remainder
    # spills up into 2048 (cheaper than a mostly-empty 1024 batch:
    # 2*(2*2048+256) < 4*(2*1024+256)), joining r4; 256 does NOT spill
    # (2*(2*1024+256) > 4*(2*256+256))
    assert len(batches) == 2
    b0 = batches[0]
    assert b0.max_len == 256 and b0.lengths[:2].tolist() == [100, 120]
    assert b0.indices.tolist() == [0, 1, -1, -1]
    # padding uses CODE_N = 4
    assert b0.codes[0, 100] == 4
    b1 = batches[1]
    assert b1.max_len == 2048
    assert sorted(i for i in b1.indices.tolist() if i >= 0) == [2, 3, 4]


def test_read_records_dispatch(tmp_path):
    p = str(tmp_path / "r.fq")
    write_fastq(p, [("x", seq_to_codes("AC"), np.array([1, 2], dtype=np.uint8))])
    recs = read_records(p)
    assert recs[0].qual is not None


def test_sam_qv_tracks_roundtrip(tmp_path):
    """samqv supplemental tracks (iq/dq/sq/mq/st/dt) survive SAM input ->
    Read -> SAM output, with orientation restored on reverse-strand records
    (SAMAlignment.h:280-296 parse, SAMPrinter.h:534-549 emission)."""
    import numpy as np

    from blasr_jax.core.encode import codes_to_seq, revcomp_codes, seq_to_codes
    from blasr_jax.io.sam import read_sam, sam_records_to_reads

    rng = np.random.default_rng(21)
    n = 40
    codes = rng.integers(0, 4, n).astype(np.uint8)
    iq = rng.integers(5, 40, n).astype(np.uint8)
    dt = rng.integers(0, 4, n).astype(np.uint8)
    seq_rc = codes_to_seq(revcomp_codes(codes))
    iq_s = (iq[::-1] + 33).tobytes().decode()          # stored in SAM orientation
    dt_s = codes_to_seq(revcomp_codes(dt))
    sam = tmp_path / "r.sam"
    sam.write_text(
        "@HD\tVN:1.5\n@SQ\tSN:chr1\tLN:1000\n"
        f"read1\t16\tchr1\t1\t30\t{n}M\t*\t0\t0\t{seq_rc}\t*\t"
        f"iq:Z:{iq_s}\tdt:Z:{dt_s}\n"
    )
    reads = sam_records_to_reads(read_sam(str(sam)))
    assert len(reads) == 1
    rd = reads[0]
    # orientation restored: tracks are in original-read coordinates
    assert np.array_equal(rd.codes, codes)
    assert np.array_equal(rd.qvs["iq"], iq)
    assert np.array_equal(rd.qvs["dt"], dt)

    # writer echoes the tags oriented with the emitted SEQ
    from blasr_jax.output.sam_writer import format_sam_record
    from blasr_jax.pipeline.runner import AlignmentRecord
    from blasr_jax.pipeline.traceback import AlignmentPath

    ops = np.full(n, 1, np.uint8)
    path = AlignmentPath(0, n, 0, n, ops, -100, n_match=n)
    rec = AlignmentRecord(
        qname=rd.name, tname="chr1", score=-100, pct_similarity=100.0,
        qstrand=0, qstart=0, qend=n, qlength=n, tstrand=1, tstart=0,
        tend=n, tlength=1000, mapqv=254, contig_index=0, tstart_fwd=0,
        tend_fwd=n, path=path, read_index=0,
    )
    line = format_sam_record(rec, rd)
    fields = dict(
        f.split(":", 2)[0::2] for f in line.split("\t")[11:] if ":" in f
    )
    assert fields["iq"] == iq_s
    assert fields["dt"] == dt_s


def test_samqv_tag_selection(tmp_path):
    """-samqv limits which supplemental tracks the SAM writer emits
    (SupplementalQVList::UseQV role)."""
    import numpy as np

    from blasr_jax.io.batching import Read
    from blasr_jax.output.sam_writer import format_sam_record
    from blasr_jax.pipeline.runner import AlignmentRecord
    from blasr_jax.pipeline.traceback import AlignmentPath

    n = 20
    rng = np.random.default_rng(5)
    rd = Read("r", rng.integers(0, 4, n).astype(np.uint8), None, 0,
              qvs={"iq": np.full(n, 10, np.uint8),
                   "dq": np.full(n, 11, np.uint8)})
    path = AlignmentPath(0, n, 0, n, np.full(n, 1, np.uint8), -50, n_match=n)
    rec = AlignmentRecord(
        qname="r", tname="c", score=-50, pct_similarity=100.0, qstrand=0,
        qstart=0, qend=n, qlength=n, tstrand=0, tstart=0, tend=n,
        tlength=100, mapqv=254, contig_index=0, tstart_fwd=0, tend_fwd=n,
        path=path, read_index=0,
    )
    line_all = format_sam_record(rec, rd)
    assert "iq:Z:" in line_all and "dq:Z:" in line_all
    line_iq = format_sam_record(rec, rd, samqv=("iq",))
    assert "iq:Z:" in line_iq and "dq:Z:" not in line_iq


def test_gzip_inputs(tmp_path):
    """FASTA/FASTQ .gz inputs read transparently."""
    import gzip

    import numpy as np

    from blasr_jax.core.encode import codes_to_seq
    from blasr_jax.io.batching import read_records

    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, 80).astype(np.uint8)
    seq = codes_to_seq(codes)
    fa = tmp_path / "r.fasta.gz"
    with gzip.open(fa, "wt") as f:
        f.write(f">r1\n{seq}\n")
    reads = read_records(str(fa))
    assert len(reads) == 1 and np.array_equal(reads[0].codes, codes)

    fq = tmp_path / "r.fastq.gz"
    with gzip.open(fq, "wt") as f:
        f.write(f"@r1\n{seq}\n+\n{'I' * len(seq)}\n")
    reads = read_records(str(fq))
    assert len(reads) == 1 and np.array_equal(reads[0].codes, codes)
    assert int(reads[0].qual[0]) == ord("I") - 33
