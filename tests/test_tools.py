"""Satellite tools + SAM reader tests (L8/L1)."""

import numpy as np
import pytest

from blasr_jax.core.encode import codes_to_seq
from blasr_jax.io.fasta import write_fasta
from blasr_jax.io.sam import read_sam, sam_records_to_reads
from blasr_jax.io.seqdb import load_genome
from blasr_jax.sim import evolve_sequence, shred_genome, simulate_genome


@pytest.fixture(scope="module")
def genome_fa(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    g = simulate_genome(30_000, seed=1)
    path = str(d / "g.fa")
    write_fasta(path, [("c1", g[:20_000]), ("c2", g[20_000:])])
    return path


def test_count_table(genome_fa):
    from blasr_jax.index.artifacts import build_count_table

    genome, _ = load_genome(genome_fa)
    k = 6
    counts = build_count_table(genome, k)
    assert counts.shape == (4**k,)
    # spot-check one k-mer against a direct scan
    key = 0b101101001110
    kmer = np.array([(key >> (2 * i)) & 3 for i in range(k - 1, -1, -1)], np.uint8)
    direct = sum(
        1
        for i in range(len(genome) - k + 1)
        if np.array_equal(genome[i : i + k], kmer)
    )
    assert counts[key] == direct


def test_shredder_tiles_genome(genome_fa):
    genome, seqdb = load_genome(genome_fa)
    reads = shred_genome(genome, seqdb, 1000, coverage=1.0)
    total = sum(len(c) for _, c in reads)
    assert total == len(genome)  # exact tiling at coverage 1
    # titles encode contig-local truth
    name, codes = reads[0]
    assert name.startswith("shred/0|c1|0|1000")
    np.testing.assert_array_equal(codes, genome[:1000])


def test_evolve_rates():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, 50_000).astype(np.uint8)
    out, stats = evolve_sequence(codes, 0.02, 0.01, 0.01, seed=5)
    assert abs(stats["n_sub"] / 50_000 - 0.02) < 0.005
    assert abs(stats["n_del"] / 50_000 - 0.01) < 0.005
    assert abs(stats["n_ins"] / 50_000 - 0.01) < 0.005
    assert abs(len(out) - 50_000) < 1000


def test_sam_roundtrip(tmp_path, genome_fa):
    """Map shredded reads -> SAM -> re-read as input reads."""
    from blasr_jax.index.artifacts import load_index
    from blasr_jax.io.batching import read_records
    from blasr_jax.output.sam_writer import write_sam
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping

    genome, seqdb = load_genome(genome_fa)
    reads_fa = str(tmp_path / "r.fa")
    write_fasta(reads_fa, shred_genome(genome, seqdb, 600)[:8])
    index = load_index(genome_fa, k=12, cache=False)
    reads = read_records(reads_fa)
    params = MappingParams(
        batch_size=8, max_read_len=1024, n_candidates=2, best_n=1,
        min_match_length=12,
    )
    records, unmapped = run_mapping(index, reads, params)
    assert not unmapped
    sam_path = str(tmp_path / "o.sam")
    with open(sam_path, "w") as f:
        write_sam(records, reads, seqdb, f)
    sam = read_sam(sam_path)
    assert sam.ref_lengths == {"c1": 20_000, "c2": 10_000}
    assert len(sam.records) == 8
    rt = sam_records_to_reads(sam)
    by_name = {r.name: r for r in rt}
    for rd in reads:
        got = by_name[rd.name]
        np.testing.assert_array_equal(got.codes, rd.codes)  # strand restored


def test_samtom4_and_filter(tmp_path, genome_fa, capsys):
    from blasr_jax.cli.tools import main as tools_main

    # reuse the SAM from a fresh tiny mapping
    test_sam_roundtrip(tmp_path, genome_fa)
    sam_path = str(tmp_path / "o.sam")
    assert tools_main(["samtom4", sam_path, "-header"]) == 0
    out = capsys.readouterr().out.strip().split("\n")
    assert len(out) == 9  # header + 8 records
    assert out[0].startswith("qname tname score")
    # perfect reads: 100% identity expected
    assert all(" 100.0000 " in line for line in out[1:])
    assert tools_main(["samfilter", sam_path, "-minPctIdentity", "99"]) == 0
    out2 = [
        l for l in capsys.readouterr().out.strip().split("\n")
        if not l.startswith("@")
    ]
    assert len(out2) == 8


def test_alchemy_roundtrip(tmp_path, genome_fa):
    """alchemy reads map back to their true loci; an error model estimated
    from aligned output reproduces plausible rates."""
    from blasr_jax.index.artifacts import load_index
    from blasr_jax.output.sam_writer import write_sam
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping
    from blasr_jax.sim import (
        ErrorModel, build_model_from_sam, parse_truth, simulate_reads_alchemy,
    )

    genome, seqdb = load_genome(genome_fa)
    model = ErrorModel.default()
    reads, truth = simulate_reads_alchemy(genome, model, 12, seed=4)
    assert all(r.qual is not None for r in reads)
    index = load_index(genome_fa, k=13, cache=False)
    # long noisy reads drift beyond the band; the pad bound routes them
    # through auto-segmentation (1 kb segments + stitching)
    params = MappingParams(
        batch_size=16, max_read_len=1024, n_candidates=2, best_n=1,
        min_match_length=13,
    )
    recs, unm = run_mapping(index, reads, params)
    best_by = {}
    for r in recs:
        if r.qname not in best_by or r.score < best_by[r.qname].score:
            best_by[r.qname] = r
    recs = list(best_by.values())
    assert len(unm) <= 1
    n_ok = 0
    for r in recs:
        start, end, strand = parse_truth(r.qname)  # genome-global coords
        g_start = int(seqdb.starts[r.contig_index]) + r.tstart_fwd
        if r.tstrand == strand and abs(g_start - start) < 100:
            n_ok += 1
    assert n_ok >= len(recs) - 1

    sam_path = str(tmp_path / "alc.sam")
    with open(sam_path, "w") as f:
        write_sam(recs, reads, seqdb, f)
    est = build_model_from_sam(sam_path)
    # estimated insertion rate should be in the ballpark of the true 10%
    import numpy as _np

    assert 0.04 < float(_np.mean(est.ins)) < 0.2
    assert sum(est.length_probs) > 0.99


def test_printgaps_extracts_sv(tmp_path):
    """printgaps (samutils/PrintGaps.cpp role): indel gaps above
    -minGapLength come out as GFF-like lines with the gap sequence."""
    import numpy as np

    from blasr_jax.cli.tools import main as tools_main
    from blasr_jax.core.encode import codes_to_seq
    from blasr_jax.io.fasta import write_fasta
    from blasr_jax.sim import simulate_genome

    g = simulate_genome(2_000, seed=31)
    gp = str(tmp_path / "g.fa")
    write_fasta(gp, [("chr1", g)])
    # read: 300 bp matching, 150 bp deletion, 300 bp matching; plus an
    # insertion of 120 novel bases mid-way through the second block
    ins = simulate_genome(120, seed=32)
    read = np.concatenate([g[100:400], g[550:700], ins, g[700:850]])
    seq = codes_to_seq(read)
    cigar = "300M150D150M120I150M"
    sam = str(tmp_path / "a.sam")
    with open(sam, "w") as f:
        f.write("@HD\tVN:1.5\n@SQ\tSN:chr1\tLN:2000\n")
        f.write(f"r1\t0\tchr1\t101\t254\t{cigar}\t*\t0\t0\t{seq}\t*\n")
    out = str(tmp_path / "gaps.txt")
    rc = tools_main(["printgaps", gp, sam, "-out", out, "-minGapLength", "100"])
    assert rc == 0
    lines = open(out).read().strip().split("\n")
    assert len(lines) == 2
    dele = [l for l in lines if "\tdeletion\t" in l][0]
    insn = [l for l in lines if "\tinsertion\t" in l][0]
    df = dele.split("\t")
    assert df[0] == "chr1" and df[3] == "400,550" and df[4] == "150"
    assert df[7] == "seq " + codes_to_seq(g[400:550])
    inf = insn.split("\t")
    assert inf[4] == "120"
    assert inf[7] == "seq " + codes_to_seq(ins)


def test_printgaps_merge_fuses_split_gap(tmp_path):
    import numpy as np

    from blasr_jax.cli.tools import main as tools_main
    from blasr_jax.core.encode import codes_to_seq
    from blasr_jax.io.fasta import write_fasta
    from blasr_jax.sim import simulate_genome

    g = simulate_genome(1_500, seed=33)
    gp = str(tmp_path / "g.fa")
    write_fasta(gp, [("chr1", g)])
    read = np.concatenate([g[0:200], g[280:285], g[365:565]])
    seq = codes_to_seq(read)
    cigar = "200M80D5M80D200M"  # one 160 bp deletion split by a 5 bp block
    sam = str(tmp_path / "a.sam")
    with open(sam, "w") as f:
        f.write("@HD\tVN:1.5\n@SQ\tSN:chr1\tLN:1500\n")
        f.write(f"r1\t0\tchr1\t1\t254\t{cigar}\t*\t0\t0\t{seq}\t*\n")
    out = str(tmp_path / "gaps.txt")
    tools_main(["printgaps", gp, sam, "-out", out,
                "-minGapLength", "100", "-merge", "10"])
    lines = open(out).read().strip().split("\n")
    assert len(lines) == 1
    f_ = lines[0].split("\t")
    assert f_[2] == "deletion" and f_[4] == "160"


def test_saquery_saprint(tmp_path, capsys):
    """SA inspector tools (SAQuery.cpp / SAPrinter.cpp roles) on a
    reference-format .sa file."""
    from blasr_jax.cli.tools import main as tools_main
    from blasr_jax.index.safile import reference_order_sa, write_sa_file
    from blasr_jax.io.fasta import write_fasta
    from blasr_jax.sim import simulate_genome

    g = simulate_genome(2_000, seed=41)
    gp = str(tmp_path / "g.fa")
    write_fasta(gp, [("chr1", g)])
    sap = str(tmp_path / "g.sa")
    write_sa_file(sap, reference_order_sa(g), g)

    # query occurring exactly once (unique 30-mer) + its positions printed
    q = g[700:730]
    qp = str(tmp_path / "q.fa")
    write_fasta(qp, [("probe", q)])
    assert tools_main(["saquery", gp, sap, qp, "-print", "-printCount"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].split()[0] == "probe"
    n = int(out[0].split()[1])
    assert n >= 1
    assert "700" in out[1 : 1 + n]

    assert tools_main(["saprint", sap, "-ps", gp, "-limit", "5"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert int(out[0]) == len(g) + 1  # sentinel row included in .sa
    # each printed row: "<pos> <50 bases>" and the bases match the genome
    from blasr_jax.core.encode import codes_to_seq

    for line in out[1:6]:
        pos, seq = line.split()
        assert seq == codes_to_seq(g[int(pos) : int(pos) + 50])


def test_svrealign_consolidates_fragmented_gap(tmp_path, capsys):
    """A 200-base deletion fragmented into two gap runs split by a tiny
    match block becomes one clean 200D after realignment
    (SVRealigner.cpp role via onegap_align)."""
    from blasr_jax.cli.tools import main as tools_main
    from blasr_jax.core.encode import codes_to_seq
    from blasr_jax.io.fasta import write_fasta
    from blasr_jax.sim import simulate_genome

    g = simulate_genome(2_000, seed=55)
    gp = str(tmp_path / "g.fa")
    write_fasta(gp, [("chr1", g)])
    # fragmented CIGAR consistent with the sequences: 300M 90D 3M 107D 297M
    # (3 "M" bases inside the gap pair up with arbitrary genome bases);
    # the true structure is one ~200-base deletion
    frag = np.concatenate([g[100:400], g[490:493], g[600:897]])
    cigar = "300M90D3M107D297M"
    sam = str(tmp_path / "a.sam")
    with open(sam, "w") as f:
        f.write("@HD\tVN:1.5\n@SQ\tSN:chr1\tLN:2000\n")
        f.write(
            f"r1\t0\tchr1\t101\t254\t{cigar}\t*\t0\t0\t"
            f"{codes_to_seq(frag)}\t*\n"
        )
    outp = str(tmp_path / "out.sam")
    assert tools_main(["svrealign", gp, sam, "-out", outp]) == 0
    body = [l for l in open(outp) if not l.startswith("@")]
    assert len(body) == 1
    new_cigar = body[0].split("\t")[5]
    # consumed lengths unchanged
    import re

    runs = re.findall(r"(\d+)([MIDSH])", new_cigar)
    q_len = sum(int(n) for n, op in runs if op in "MIS")
    t_len = sum(int(n) for n, op in runs if op in "MD")
    assert q_len == len(frag) and t_len == 797
    # the gap is now consolidated: a single D run of ~197-200
    d_runs = [int(n) for n, op in runs if op == "D"]
    assert len(d_runs) == 1 and d_runs[0] >= 190, new_cigar


def test_maxalignedread_support_track(tmp_path):
    """Anchor-depth track (PrintMaxAlignedRead role): positions deep inside
    a read get higher support than alignment tails."""
    import struct

    from blasr_jax.cli.tools import main as tools_main

    sam = str(tmp_path / "a.sam")
    with open(sam, "w") as f:
        f.write("@HD\tVN:1.5\n@SQ\tSN:chr1\tLN:1000\n")
        # one 400-base alignment at pos 101 (0-based 100..500)
        f.write("r1\t0\tchr1\t101\t254\t400M\t*\t0\t0\t" + "A" * 400 + "\t*\n")
    outd = str(tmp_path / "out")
    assert tools_main(["maxalignedread", "-sam", sam, "-outDir", outd,
                       "-bin", "10"]) == 0
    raw = open(outd + "/chr1.data", "rb").read()
    bs, n = struct.unpack("<ii", raw[:8])
    assert bs == 10 and n == 100
    import numpy as np

    counts = np.frombuffer(raw[8 : 8 + 4 * n], np.uint32)
    support = np.frombuffer(raw[8 + 4 * n :], np.uint32)
    assert counts[15] == 10          # fully covered bin
    assert counts[5] == 0            # before the alignment
    # support peaks at the middle (~200) and tapers at the ends
    assert support[30] == 200 or support[29] == 199
    assert support[10] < 15 and support[49] < 15


def test_small_sequtils(tmp_path, capsys):
    """masksequence / exciserepeats / extractseq / revcomp / countnmers
    (sequtils roles)."""
    from blasr_jax.cli.tools import main as tools_main
    from blasr_jax.core.encode import CODE_N, codes_to_seq, revcomp_codes
    from blasr_jax.io.fasta import read_fasta, write_fasta

    rng = np.random.default_rng(13)
    g = rng.integers(0, 4, 500).astype(np.uint8)
    gp = str(tmp_path / "g.fa")
    write_fasta(gp, [("chr1", g)])
    tbl = str(tmp_path / "t.txt")
    open(tbl, "w").write("chr1 100 150\nchr1 300 310\n")

    mp = str(tmp_path / "m.fa")
    assert tools_main(["masksequence", gp, tbl, mp]) == 0
    m = dict(read_fasta(mp))["chr1"]
    assert (m[100:150] == CODE_N).all() and (m[0:100] == g[0:100]).all()

    ep = str(tmp_path / "e.fa")
    assert tools_main(["exciserepeats", gp, tbl, ep]) == 0
    e = dict(read_fasta(ep))["chr1"]
    assert len(e) == 500 - 50 - 10
    assert (e[:100] == g[:100]).all() and (e[100:250] == g[150:300]).all()

    assert tools_main(["extractseq", gp, "chr1:10-20"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1] == codes_to_seq(g[10:20])

    rp = str(tmp_path / "r.fa")
    assert tools_main(["revcomp", gp, "-out", rp]) == 0
    r = dict(read_fasta(rp))["chr1"]
    assert (r == revcomp_codes(g)).all()

    assert tools_main(["countnmers", gp, "-wordsize", "10"]) == 0
    out = capsys.readouterr().out.split()
    assert int(out[1]) == 500 - 10 + 1
    assert 0 < int(out[0]) <= int(out[1])


def test_longestrepeat(tmp_path, capsys):
    from blasr_jax.cli.tools import main as tools_main
    from blasr_jax.io.fasta import write_fasta

    rng = np.random.default_rng(3)
    g = rng.integers(0, 4, 3000).astype(np.uint8)
    g[2000:2180] = g[500:680]  # plant a 180-base repeat
    write_fasta(str(tmp_path / "g.fa"), [("c", g)])
    assert tools_main(["longestrepeat", str(tmp_path / "g.fa")]) == 0
    out = capsys.readouterr().out
    ln = int(out.split("repeat length ")[1].split()[0])
    assert ln >= 180, out
    pos = out.splitlines()[0]
    assert ("500" in pos and "2000" in pos) or ln > 180


def test_removeadapters_splits_smrtbell(tmp_path, capsys):
    """SMRTBell read = insert + adapter + RC(insert): splitting at the
    adapter yields two passes (RemoveAdapters.cpp SplitRead role)."""
    from blasr_jax.cli.tools import main as tools_main
    from blasr_jax.core.encode import revcomp_codes
    from blasr_jax.io.fasta import read_fasta, write_fasta

    rng = np.random.default_rng(8)
    adapter = rng.integers(0, 4, 45).astype(np.uint8)
    insert = rng.integers(0, 4, 400).astype(np.uint8)
    read = np.concatenate([insert, adapter, revcomp_codes(insert)])
    write_fasta(str(tmp_path / "ad.fa"), [("adapter", adapter)])
    write_fasta(str(tmp_path / "r.fa"), [("zmw", read)])
    outp = str(tmp_path / "out.fa")
    assert tools_main([
        "removeadapters", "-ad1", str(tmp_path / "ad.fa"),
        "-reads", str(tmp_path / "r.fa"), "-readsout", outp,
        "-pctSim", "0.8",
    ]) == 0
    passes = read_fasta(outp)
    assert len(passes) == 2, [n for n, _ in passes]
    (n1, c1), (n2, c2) = passes
    assert abs(len(c1) - 400) <= 5 and abs(len(c2) - 400) <= 5
    assert (c1[:380] == insert[:380]).all()


def test_extract_gff_sequences(tmp_path, capsys):
    from blasr_jax.cli.tools import main as tools_main
    from blasr_jax.io.fasta import write_fasta
    from blasr_jax.sim import simulate_genome
    from blasr_jax.core.encode import codes_to_seq

    g = simulate_genome(500, seed=9)
    write_fasta(str(tmp_path / "chrZ.fa"), [("chrZ", g)])
    gff = tmp_path / "d.gff"
    gff.write_text("chrZ dup 99.1 10 60\nchrZ dup 88.0 100 140\n")
    assert tools_main(["extractGFFSequences", str(gff), str(tmp_path)]) == 0
    out = capsys.readouterr().out.strip().split("\n")
    assert out[0] == ">chrZ_10_60"
    assert out[1] == codes_to_seq(g[10:60])
    assert out[2] == ">chrZ_100_140"
    assert out[3] == codes_to_seq(g[100:140])


def test_match_gtf_exons(tmp_path, capsys):
    from blasr_jax.cli.tools import main as tools_main

    gtf = tmp_path / "a.gtf"
    gtf.write_text(
        'chr1\tHAVANA\texon\t100\t200\t.\t+\t.\tgene_id "G1"; '
        'gene_name "FAM"; transcript_id "T1";\n'
        'chr1\tHAVANA\texon\t500\t600\t.\t+\t.\tgene_id "G2"; '
        'gene_name "BAR"; transcript_id "T2";\n'
    )
    aln = tmp_path / "a.m4"
    # m4: qname tname score pct qstrand qstart qend qlen tstrand tstart tend tlen mapqv
    aln.write_text(
        "r1 chr1 -100 95.0 0 0 100 100 0 110 190 1000 254\n"    # inside exon 1
        "r2 chr1 -100 95.0 1 0 100 100 1 395 495 1000 254\n"    # rc: fwd 505-606 -> exon 2
        "r3 chr1 -100 95.0 0 0 100 100 0 800 900 1000 254\n"    # no exon
    )
    assert tools_main(["matchGTFExons", str(aln), str(gtf), "-format", "m4"]) == 0
    out = capsys.readouterr().out
    assert " match chr1 100 200 exon FAM T1" in out
    assert " match chr1 500 600 exon BAR T2" in out
    assert "*** NO MATCHES ***" in out
