"""-fullMetrics / -clusters / -lcpBounds diagnostic side channels
(reference MappingMetrics.h:307 PrintFullList, Blasr.cpp:4536 cluster
header, MapBySuffixArray.h:77-85 lcp widths)."""

import numpy as np

from blasr_jax.cli.blasr import main as blasr_main
from blasr_jax.io.fasta import write_fasta
from blasr_jax.sim import simulate_genome, simulate_reads


def _corpus(tmp_path, n=12):
    g = simulate_genome(40_000, seed=71, repeat_fraction=0.0)
    gp = str(tmp_path / "g.fa")
    write_fasta(gp, [("ref", g)])
    reads, _ = simulate_reads(g, n, mean_len=400, seed=72)
    rp = str(tmp_path / "r.fa")
    write_fasta(rp, [(r.name, r.codes) for r in reads])
    return rp, gp, g, reads


def test_diagnostic_outputs(tmp_path):
    rp, gp, g, reads = _corpus(tmp_path)
    fm_p = str(tmp_path / "full.txt")
    cl_p = str(tmp_path / "clusters.txt")
    lb_p = str(tmp_path / "lcp.txt")
    rc = blasr_main(
        [rp, gp, "-m", "4", "-out", str(tmp_path / "o.m4"),
         "-batchSize", "8", "-maxReadLen", "1024", "-minMatch", "13",
         "-fullMetrics", fm_p, "-clusters", cl_p, "-lcpBounds", lb_p]
    )
    assert rc == 0

    # fullMetrics: comment + header + one row per read
    lines = open(fm_p).read().strip().split("\n")
    assert lines[0].startswith("#")
    assert lines[1].split() == [
        "Read", "Length", "Mapped", "NAlignments", "BestScore", "MapQV",
        "MappedBases", "Cells",
    ]
    rows = [l.split() for l in lines[2:]]
    assert len(rows) == len(reads)
    mapped = [r for r in rows if r[2] == "1"]
    assert len(mapped) >= len(reads) - 1
    for r in mapped:
        assert int(r[3]) >= 1              # n alignments
        assert int(r[4]) < 0               # best score negative
        assert int(r[6]) > 0               # mapped bases

    # clusters: reference header (verbatim Blasr.cpp:4536) + >=1 row
    clines = open(cl_p).read().strip().split("\n")
    assert clines[0] == (
        "total_size p_value n_anchors read_length align_score "
        "read_accuracy anchor_probability min_exp_anchors seq_length"
    )
    assert len(clines) >= 2
    for l in clines[1:3]:
        f = l.split()
        assert len(f) == 9
        assert 0.0 <= float(f[5]) <= 1.0   # read_accuracy

    # lcpBounds: 2 lines per read (fwd, rc), widths match a brute-force
    # count of genome k-mer occurrences at spot-checked positions
    blines = open(lb_p).read().split("\n")
    assert len([l for l in blines if l != ""]) >= 2 * len(reads) - 2
    widths = [int(w) for w in blines[0].split()]
    rd = reads[0].codes
    k = 13
    gs = g.tobytes()
    for pos in (0, len(widths) // 2, len(widths) - 1):
        kmer = rd[pos : pos + k].tobytes()
        expect = gs.count(kmer)  # non-overlapping undercount is fine below
        # width counts ALL (incl. overlapping) occurrences: count manually
        cnt = sum(
            1 for i in range(len(gs) - k + 1) if gs[i : i + k] == kmer
        )
        assert widths[pos] == cnt
