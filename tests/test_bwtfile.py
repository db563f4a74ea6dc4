"""Reference .bwt interop: invert a sa2bwt-generated golden artifact."""

import os

import numpy as np

from blasr_jax.index.bwtfile import read_ref_bwt, ref_bwt_genome_matches

DATA = os.path.join(os.path.dirname(__file__), "data")


def test_golden_ref_bwt_inverts_to_genome():
    """The checked-in .bwt was produced by the REFERENCE sa2bwt binary
    (sawritermc .sa -> bwtutils/SuffixArrayToBWT.cpp) over a 2-contig
    50 kb genome; inversion must recover the exact concatenation."""
    z = np.load(os.path.join(DATA, "ref_golden_genome.npz"))
    contigs = [("c1", z["c1"]), ("c2", z["c2"])]
    genome = read_ref_bwt(os.path.join(DATA, "ref_golden.bwt"))
    assert ref_bwt_genome_matches(genome, contigs)
    # N spacers in the reference's join convention
    assert genome[30000] == 4 and genome[-1] == 4
    assert len(genome) == 30000 + 1 + 20000 + 1


def test_ref_bwt_feeds_fm_serving():
    """A reference .bwt is enough to build and query our FM index."""
    from blasr_jax.index.fm import build_fm_index, count_host, locate_host
    from blasr_jax.index.suffix_array import build_suffix_array

    genome = read_ref_bwt(os.path.join(DATA, "ref_golden.bwt"))
    fm = build_fm_index(genome, build_suffix_array(genome))
    probe = genome[1234:1254]
    lo, hi = count_host(fm, probe)
    assert hi > lo
    assert 1234 in [locate_host(fm, r) for r in range(lo, hi)]
