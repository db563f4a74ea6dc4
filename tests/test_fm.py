"""FM-index: host build + device search vs oracles (L2/L3 BWT path)."""

import numpy as np
import jax.numpy as jnp
import pytest

from blasr_jax.index.fm import (
    SAMPLE_D, build_fm_index, count_host, locate_host,
)
from blasr_jax.index.suffix_array import build_suffix_array
from blasr_jax.ops.fm_search import find_anchors_fm, fm_count_kmers, fm_locate


@pytest.fixture(scope="module")
def fm_setup():
    rng = np.random.default_rng(11)
    g = rng.integers(0, 4, 8000).astype(np.uint8)
    g[500:520] = 4  # N island
    sa = build_suffix_array(g)
    fm = build_fm_index(g, sa)
    return g, sa, fm


def brute_locs(g, p):
    k = len(p)
    return [
        i for i in range(len(g) - k + 1) if np.array_equal(g[i : i + k], p)
    ]


def test_host_count_locate(fm_setup):
    g, sa, fm = fm_setup
    rng = np.random.default_rng(1)
    for _ in range(60):
        k = int(rng.integers(2, 13))
        s = int(rng.integers(0, len(g) - k))
        p = g[s : s + k].copy()
        lo, hi = count_host(fm, p)
        locs = brute_locs(g, p)
        assert hi - lo == len(locs)
        assert sorted(locate_host(fm, r) for r in range(lo, hi)) == locs


def test_device_count_matches_host(fm_setup):
    g, sa, fm = fm_setup
    rng = np.random.default_rng(2)
    k = 10
    B, L = 4, 64
    codes = np.zeros((B, L), np.uint8)
    for b in range(B):
        s = int(rng.integers(0, len(g) - L))
        codes[b] = g[s : s + L]
    lengths = np.full(B, L, np.int32)
    lo, hi = fm_count_kmers(
        jnp.asarray(fm.bwt_rows), jnp.asarray(fm.occ_bins), jnp.asarray(fm.C),
        jnp.asarray(codes), jnp.asarray(lengths), k, fm.n,
    )
    lo, hi = np.asarray(lo), np.asarray(hi)
    for b in range(B):
        for p in range(0, L - k, 7):
            want = count_host(fm, codes[b, p : p + k])
            assert (lo[b, p], hi[b, p]) == want, (b, p)


def test_device_locate_matches_host(fm_setup):
    g, sa, fm = fm_setup
    rng = np.random.default_rng(3)
    rows = rng.integers(0, fm.n, 256).astype(np.int32)
    got = np.asarray(
        fm_locate(
            jnp.asarray(fm.bwt_rows), jnp.asarray(fm.occ_bins),
            jnp.asarray(fm.C), jnp.asarray(fm.ssa_mask),
            jnp.asarray(fm.ssa_base), jnp.asarray(fm.ssa_vals),
            jnp.asarray(rows),
        )
    )
    for r, gpos in zip(rows, got):
        assert gpos == locate_host(fm, int(r)), int(r)


def test_fm_anchors_match_sa_anchors(fm_setup):
    """FM anchor search must find the same (t, q) hit set as the SA path."""
    from blasr_jax.ops.anchors import find_anchors

    g, sa, fm = fm_setup
    rng = np.random.default_rng(4)
    k = 12
    B, L = 2, 96
    codes = np.zeros((B, L), np.uint8)
    for b in range(B):
        s = int(rng.integers(0, len(g) - L))
        codes[b] = g[s : s + L]
    lengths = np.full(B, L, np.int32)
    pos_ok = np.ones(len(g), bool)

    # SA path needs its own artifacts (N -> A projection + packed keys)
    from blasr_jax.core.encode import pack_kmers

    proj = (g & 3).astype(np.uint8)
    sa_p = build_suffix_array(proj)
    keys, valid = pack_kmers(g, k)
    sa_kmers = keys[sa_p].astype(np.int32)

    t1, q1, nh1, v1 = find_anchors(
        jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(sa_p.astype(np.int32)),
        jnp.asarray(sa_kmers), jnp.asarray(valid),
        k=k, max_hits_per_pos=8, max_anchors_per_read=256,
    )
    t2, q2, nh2, v2 = find_anchors_fm(
        jnp.asarray(codes), jnp.asarray(lengths),
        jnp.asarray(fm.bwt_rows), jnp.asarray(fm.occ_bins), jnp.asarray(fm.C),
        jnp.asarray(fm.ssa_mask), jnp.asarray(fm.ssa_base),
        jnp.asarray(fm.ssa_vals), jnp.asarray(pos_ok),
        k=k, n=fm.n, max_hits_per_pos=8, max_anchors_per_read=256,
    )
    for b in range(B):
        s1 = {(int(t), int(q)) for t, q, v in zip(np.asarray(t1)[b], np.asarray(q1)[b], np.asarray(v1)[b]) if v}
        s2 = {(int(t), int(q)) for t, q, v in zip(np.asarray(t2)[b], np.asarray(q2)[b], np.asarray(v2)[b]) if v}
        assert s1 == s2, f"read {b}: SA {len(s1)} vs FM {len(s2)} anchors"


def test_e2e_mapping_with_fm_matches_sa(tmp_path):
    """Full pipeline with -bwt anchoring must produce the same records."""
    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.batching import Read
    from blasr_jax.io.seqdb import SeqDB
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping
    from blasr_jax.sim import simulate_genome, simulate_reads

    g = simulate_genome(50_000, seed=9, repeat_fraction=0.0)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    index = build_index_from_arrays(g, seqdb, k=12)
    fm = build_fm_index(g, build_suffix_array(g))
    reads, _ = simulate_reads(g, 12, mean_len=500, seed=2)
    params = MappingParams(
        batch_size=16, max_read_len=1024, n_candidates=2, best_n=1,
        min_match_length=12,
    )
    rec_sa, unm_sa = run_mapping(index, reads, params)
    rec_fm, unm_fm = run_mapping(index, reads, params, fm=fm)
    assert unm_sa == unm_fm == []
    assert len(rec_sa) == len(rec_fm)
    for a, b in zip(rec_sa, rec_fm):
        assert (a.qname, a.tstart, a.tend, a.tstrand, a.score) == (
            b.qname, b.tstart, b.tend, b.tstrand, b.score
        )


def test_fm_row_boundary_genome():
    """(G+1) % 128 == 0 regression: occ at interval end == n must count the
    full final row."""
    rng = np.random.default_rng(99)
    g = rng.integers(0, 4, 255).astype(np.uint8)   # n = 256 = 2 rows
    sa = build_suffix_array(g)
    fm = build_fm_index(g, sa)
    for _ in range(40):
        k = int(rng.integers(2, 9))
        s = int(rng.integers(0, len(g) - k))
        p = g[s : s + k].copy()
        lo, hi = count_host(fm, p)
        locs = brute_locs(g, p)
        assert hi - lo == len(locs)
    # device path too
    codes = g[:64][None, :]
    lo, hi = fm_count_kmers(
        jnp.asarray(fm.bwt_rows), jnp.asarray(fm.occ_bins), jnp.asarray(fm.C),
        jnp.asarray(codes), jnp.asarray(np.array([64], np.int32)), 6, fm.n,
    )
    lo, hi = np.asarray(lo), np.asarray(hi)
    for p_ in range(0, 58, 5):
        want = count_host(fm, codes[0, p_ : p_ + 6])
        assert (lo[0, p_], hi[0, p_]) == want, p_


def test_fm_reconstruct_roundtrip():
    """BWT inversion: genome + full SA recovered from the FM bundle alone
    (completeness property behind reference bwt2sa,
    bwtutils/BwtToSuffixArray.cpp:24-28)."""
    from blasr_jax.index.fm import build_fm_index, fm_reconstruct

    rng = np.random.default_rng(9)
    g = rng.integers(0, 4, 4097).astype(np.uint8)  # crosses ROW boundaries
    sa = build_suffix_array(g)
    fm = build_fm_index(g, sa)
    g2, sa_full = fm_reconstruct(fm)
    assert np.array_equal(g, g2)
    assert sa_full[0] == len(g)
    assert np.array_equal(sa_full[1:], sa)


def test_bwt2sa_and_locatelist_cli(tmp_path, capsys):
    from blasr_jax.cli.bwtutils import main
    from blasr_jax.index.fm import build_fm_index
    from blasr_jax.index.safile import read_sa_file
    from blasr_jax.io.fasta import write_fasta

    rng = np.random.default_rng(12)
    g = rng.integers(0, 4, 3000).astype(np.uint8)
    fm = build_fm_index(g, build_suffix_array(g))
    fmp = str(tmp_path / "g.btfm.npz")
    fm.save(fmp)

    sap = str(tmp_path / "g.sa")
    assert main(["bwt2sa", fmp, sap]) == 0
    sa_read = read_sa_file(sap)
    assert np.array_equal(sa_read, build_suffix_array(g))

    # locatelist: two query sequences with known occurrence sets
    q1 = g[100:120]
    q2 = np.array([0, 1, 2, 3] * 5, np.uint8)
    write_fasta(str(tmp_path / "q.fa"), [("q1", q1), ("q2", q2)])
    assert main(["locatelist", fmp, str(tmp_path / "q.fa"), "-print"]) == 0
    out = capsys.readouterr().out.splitlines()
    # q1 occurs at least at 100 and its position is printed
    i1 = next(i for i, l in enumerate(out) if l.startswith("q1 "))
    n1 = int(out[i1].split()[1])
    assert n1 >= 1
    positions = [int(x) for x in out[i1 + 1 : i1 + 1 + n1]]
    assert 100 in positions


def test_fm_occ_bitmask_rank_matches_row_gather():
    """fm_occ's popcount path (bit-packed per-char masks, the -bwt serving
    form) must equal the row-gather form for every (char, position)."""
    import numpy as np
    import jax.numpy as jnp

    from blasr_jax.index.fm import ROW, build_fm_index
    from blasr_jax.index.suffix_array import build_suffix_array
    from blasr_jax.ops.fm_search import build_bit_masks, fm_occ
    from blasr_jax.sim import simulate_genome

    g = simulate_genome(5_000, seed=13)
    fm = build_fm_index(g, build_suffix_array(g))
    masks = jnp.asarray(build_bit_masks(fm.bwt_rows))
    bwt = jnp.asarray(fm.bwt_rows)
    occ = jnp.asarray(fm.occ_bins)
    rng = np.random.default_rng(4)
    i = jnp.asarray(
        np.concatenate([
            rng.integers(0, fm.n + 1, 3000),
            np.array([0, 1, fm.n - 1, fm.n, ROW, ROW - 1]),
        ]).astype(np.int32)
    )
    for c in range(6):
        cv = jnp.full(i.shape, c, jnp.int32)
        a = np.asarray(fm_occ(bwt, occ, cv, i))
        b = np.asarray(fm_occ(bwt, occ, cv, i, masks))
        np.testing.assert_array_equal(a, b)


def test_fm_anchor_stride_matches_sa_sets():
    """find_anchors_fm(anchor_stride=4) must anchor the same strided
    position set as the SA path (the serving pipeline passes the same
    stride to both engines)."""
    from blasr_jax.core.encode import pack_kmers
    from blasr_jax.ops.anchors import find_anchors

    rng = np.random.default_rng(21)
    k, B = 12, 6
    g = rng.integers(0, 4, 30_000).astype(np.uint8)
    fm = build_fm_index(g, build_suffix_array(g))
    pos_ok = np.ones(len(g), bool)
    pos_ok[len(g) - k + 1 :] = False
    codes = np.full((B, 400), 4, np.uint8)
    lengths = np.zeros(B, np.int32)
    for b in range(B):
        s = int(rng.integers(0, len(g) - 400))
        codes[b, :400] = g[s : s + 400]
        lengths[b] = 400
    sa_p = build_suffix_array(g)
    keys, valid = pack_kmers(g, k)
    sa_kmers = keys[sa_p].astype(np.int32)
    t1, q1, nh1, v1 = find_anchors(
        jnp.asarray(codes), jnp.asarray(lengths),
        jnp.asarray(sa_p.astype(np.int32)), jnp.asarray(sa_kmers),
        jnp.asarray(valid),
        k=k, max_hits_per_pos=8, max_anchors_per_read=256, anchor_stride=4,
    )
    t2, q2, nh2, v2 = find_anchors_fm(
        jnp.asarray(codes), jnp.asarray(lengths),
        jnp.asarray(fm.bwt_rows), jnp.asarray(fm.occ_bins),
        jnp.asarray(fm.C), jnp.asarray(fm.ssa_mask),
        jnp.asarray(fm.ssa_base), jnp.asarray(fm.ssa_vals),
        jnp.asarray(pos_ok),
        k=k, n=fm.n, max_hits_per_pos=8, max_anchors_per_read=256,
        anchor_stride=4,
    )
    for b in range(B):
        s1 = {(int(t), int(q)) for t, q, v in zip(
            np.asarray(t1)[b], np.asarray(q1)[b], np.asarray(v1)[b]) if v}
        s2 = {(int(t), int(q)) for t, q, v in zip(
            np.asarray(t2)[b], np.asarray(q2)[b], np.asarray(v2)[b]) if v}
        assert s1 == s2, f"read {b}: SA {len(s1)} vs FM {len(s2)}"
