"""Long-query piecewise mapping (-alignContigs path)."""

import numpy as np

from blasr_jax.core.encode import revcomp_codes
from blasr_jax.index.artifacts import build_index_from_arrays
from blasr_jax.io.batching import Read
from blasr_jax.io.seqdb import SeqDB
from blasr_jax.params import MappingParams
from blasr_jax.pipeline.piecewise import run_mapping_piecewise, split_long_reads
from blasr_jax.sim import simulate_genome


def _setup():
    g = simulate_genome(80_000, seed=31, repeat_fraction=0.0)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    index = build_index_from_arrays(g, seqdb, k=13)
    params = MappingParams(
        batch_size=16, max_read_len=1024, n_candidates=2, best_n=1,
        min_match_length=13, piecewise=True,
    )
    return g, index, params


def test_split_long_reads():
    r = Read("long", np.zeros(2500, np.uint8), None, 0)
    segs, parents = split_long_reads([r], 1024)
    assert len(segs) == 3 and "long" in parents
    assert [len(s) for s in segs] == [1024, 1024, 452]


def test_piecewise_contig_fwd():
    g, index, params = _setup()
    contig = g[10_000:30_000].copy()  # 20 kb query = 20 segments
    reads = [Read("contig0", contig, None, 0)]
    recs, unm = run_mapping_piecewise(index, reads, params)
    assert not unm
    assert len(recs) == 1, [r.qstart for r in recs]
    r = recs[0]
    assert r.tstrand == 0
    assert abs(r.tstart_fwd - 10_000) < 50 and abs(r.tend_fwd - 30_000) < 50
    assert r.qstart < 50 and r.qend > 19_950
    assert r.pct_similarity > 99.0


def test_piecewise_contig_rc():
    g, index, params = _setup()
    contig = revcomp_codes(g[40_000:60_000].copy())
    reads = [Read("contigrc", contig, None, 0)]
    recs, unm = run_mapping_piecewise(index, reads, params)
    assert not unm
    assert len(recs) == 1
    r = recs[0]
    assert r.tstrand == 1
    assert abs(r.tstart_fwd - 40_000) < 50 and abs(r.tend_fwd - 60_000) < 50


def test_piecewise_inversion_splits():
    """An inverted middle block must split the chain into >= 2 pieces with
    opposite strands (PiecewiseMatch's strand-switch behavior)."""
    g, index, params = _setup()
    a = g[10_000:18_000]
    b = revcomp_codes(g[18_000:26_000].copy())
    c = g[26_000:34_000]
    contig = np.concatenate([a, b, c])
    reads = [Read("inv", contig, None, 0)]
    recs, unm = run_mapping_piecewise(index, reads, params)
    assert not unm
    strands = sorted(r.tstrand for r in recs)
    assert len(recs) >= 3
    assert 0 in strands and 1 in strands


def test_short_reads_pass_through():
    g, index, params = _setup()
    reads = [Read("short", g[5_000:5_700].copy(), None, 0)]
    recs, unm = run_mapping_piecewise(index, reads, params)
    assert not unm and len(recs) == 1
    assert abs(recs[0].tstart_fwd - 5_000) < 50


def test_piecewise_rc_path_consistent():
    """RC piecewise merge: replayed path must match the sequences exactly
    (regression: ops were concatenated in forward-read order, which is
    reversed for RC hits)."""
    g, index, params = _setup()
    # forward target slice with one 40 bp deletion in the read
    seg = np.concatenate([g[30_000:31_480], g[31_520:33_000]])
    read = revcomp_codes(seg.copy())
    reads = [Read("rcdel", read, None, 0)]
    recs, unm = run_mapping_piecewise(index, reads, params)
    assert not unm
    best = min(recs, key=lambda r: r.score)
    assert best.tstrand == 1
    p = best.path
    # replay: count real matches along the path against the sequences
    q = revcomp_codes(read)  # RC of read = target-forward orientation
    t = g[30_000 + 0 : 30_000 + 3_000]
    qi = p.q_start
    ti = best.tstart_fwd - 30_000
    n_match = 0
    n_mm = 0
    for op in p.ops:
        if op == 1:
            if q[qi] == t[ti]:
                n_match += 1
            else:
                n_mm += 1
            qi += 1
            ti += 1
        elif op == 2:
            qi += 1
        else:
            ti += 1
    assert n_mm <= 2, f"path inconsistent: {n_mm} mismatches on error-free read"
    assert n_match >= 2_900


def test_colinear_selection_survives_repeat_segments():
    """A contig whose middle segment lies inside a genomic repeat must
    stitch into ONE record: joint colinear selection (PiecewiseMatch role)
    picks the in-chain copy even when an out-of-chain copy scores equally."""
    rng = np.random.default_rng(91)
    g = rng.integers(0, 4, 200_000).astype(np.uint8)
    # plant an exact repeat: copy [50k, 53k) to [150k, 153k)
    g[150_000:153_000] = g[50_000:53_000]
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    index = build_index_from_arrays(g, seqdb, k=13)
    # contig = [46k, 58k): segments inside [50k,53k) are ambiguous
    contig = g[46_000:58_000].copy()
    reads = [Read("ctg", contig, None, 0)]
    params = MappingParams(
        batch_size=16, max_read_len=2048, n_candidates=4, best_n=1,
        min_match_length=13, piecewise=True, segment_length=1024,
    )
    recs, unm = run_mapping_piecewise(index, reads, params)
    assert len(recs) == 1, [
        (r.qstart, r.qend, r.tstart_fwd, r.score) for r in recs
    ]
    r = recs[0]
    assert r.qstart == 0 and r.qend == len(contig)
    assert abs(r.tstart_fwd - 46_000) < 50
    assert r.pct_similarity > 99.9
