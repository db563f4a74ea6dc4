import numpy as np
import jax.numpy as jnp

from blasr_jax.core.encode import revcomp_codes
from blasr_jax.index.artifacts import build_index_from_arrays
from blasr_jax.io.seqdb import SeqDB
from blasr_jax.ops.anchors import find_anchors, pack_query_kmers


def _make_index(genome, k=8):
    seqdb = SeqDB(["chr"], np.array([0, len(genome)], dtype=np.int64), ["0" * 32])
    return build_index_from_arrays(genome, seqdb, k)


def _brute_force_anchors(genome, read, k):
    """All (t, q) exact k-mer matches."""
    out = set()
    gs = genome.tobytes()
    for q in range(len(read) - k + 1):
        km = read[q : q + k]
        if (km >= 4).any():
            continue
        kmb = km.tobytes()
        start = 0
        while True:
            t = gs.find(kmb, start)
            if t < 0 or t + k > len(genome):
                break
            out.add((t, q))
            start = t + 1
    return out


def test_find_anchors_exact_match(rng):
    genome = rng.integers(0, 4, size=5000).astype(np.uint8)
    k = 8
    idx = _make_index(genome, k)
    # read = exact slice of genome
    start = 1234
    read = genome[start : start + 200].copy()
    codes = np.full((2, 256), 4, dtype=np.uint8)
    codes[0, :200] = read
    lengths = np.array([200, 0], dtype=np.int32)

    t, q, nh, valid = find_anchors(
        jnp.asarray(codes), jnp.asarray(lengths),
        jnp.asarray(idx.sa), jnp.asarray(idx.sa_kmers), jnp.asarray(idx.pos_ok),
        k=k, max_hits_per_pos=8, max_anchors_per_read=512,
    )
    t, q, nh, valid = map(np.asarray, (t, q, nh, valid))
    got = set(zip(t[0][valid[0]].tolist(), q[0][valid[0]].tolist()))
    want = _brute_force_anchors(genome, read, k)
    # every found anchor must be a true match
    assert got <= want
    # the on-diagonal anchors (t = start + q) must be well represented
    diag = {(start + qq, qq) for qq in range(0, 200 - k + 1)} & want
    assert len(got & diag) >= 0.9 * len(diag)
    # padded row yields nothing
    assert not valid[1].any()


def test_anchor_nhits_is_kmer_frequency(rng):
    # genome with a 3x repeated block
    block = rng.integers(0, 4, size=100).astype(np.uint8)
    unique = rng.integers(0, 4, size=3000).astype(np.uint8)
    genome = np.concatenate([block, unique[:1000], block, unique[1000:2000], block])
    k = 10
    idx = _make_index(genome, k)
    read = block[:60].copy()
    codes = np.full((1, 128), 4, dtype=np.uint8)
    codes[0, :60] = read
    lengths = np.array([60], dtype=np.int32)
    t, q, nh, valid = find_anchors(
        jnp.asarray(codes), jnp.asarray(lengths),
        jnp.asarray(idx.sa), jnp.asarray(idx.sa_kmers), jnp.asarray(idx.pos_ok),
        k=k, max_hits_per_pos=8, max_anchors_per_read=512,
    )
    nh = np.asarray(nh)
    valid = np.asarray(valid)
    # block k-mers appear >= 3 times
    assert nh[valid].min() >= 3


def test_pack_query_kmers_matches_host(rng):
    from blasr_jax.core.encode import pack_kmers

    codes = rng.integers(0, 5, size=(3, 64)).astype(np.uint8)
    lengths = np.array([64, 30, 0], dtype=np.int32)
    k = 6
    qk = np.asarray(pack_query_kmers(jnp.asarray(codes), jnp.asarray(lengths), k))
    for b in range(3):
        keys, valid = pack_kmers(codes[b], k)
        n = lengths[b]
        for i in range(64):
            ok = valid[i] and i + k <= n
            if ok:
                assert qk[b, i] == keys[i]
            else:
                assert qk[b, i] == -1


def test_lut_search_matches_plain(rng):
    """Prefix-LUT-jumpstarted search must equal the full binary search."""
    import jax.numpy as jnp

    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.seqdb import SeqDB

    g = rng.integers(0, 4, 30_000).astype(np.uint8)
    seqdb = SeqDB(["r"], np.array([0, len(g)], np.int64), ["0" * 32])
    idx = build_index_from_arrays(g, seqdb, k=12)
    lut, shift, max_steps = idx.lut()
    B, L = 4, 128
    codes = np.zeros((B, L), np.uint8)
    for b in range(B):
        s = int(rng.integers(0, len(g) - L))
        codes[b] = g[s : s + L]
    lengths = np.full(B, L, np.int32)
    args = (
        jnp.asarray(codes), jnp.asarray(lengths),
        jnp.asarray(idx.sa.astype(np.int32)), jnp.asarray(idx.sa_kmers),
        jnp.asarray(idx.pos_ok),
    )
    plain = find_anchors(*args, k=12, max_hits_per_pos=8, max_anchors_per_read=256)
    lutted = find_anchors(
        *args, jnp.asarray(lut), k=12, max_hits_per_pos=8,
        max_anchors_per_read=256, lut_meta=(shift, max_steps),
    )
    for a, b in zip(plain, lutted):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_wide_key_anchors_match_bruteforce(rng):
    """k=18 (int64 keys split hi/lo on device) vs a brute-force scan."""
    import jax.numpy as jnp

    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.seqdb import SeqDB
    from blasr_jax.ops.anchors import find_anchors_wide

    k = 18
    g = rng.integers(0, 4, 6000).astype(np.uint8)
    # plant a duplicated block so some k-mers have multiple hits
    g[3000:3300] = g[1000:1300]
    seqdb = SeqDB(["r"], np.array([0, len(g)], np.int64), ["0" * 32])
    idx = build_index_from_arrays(g, seqdb, k=k)
    assert idx.sa_kmers.dtype == np.int64
    lut, shift, max_steps = idx.lut()

    B, L = 2, 96
    codes = np.zeros((B, L), np.uint8)
    for b in range(B):
        s = int(rng.integers(1000, 1300 - L))
        codes[b] = g[s : s + L]
    lengths = np.full(B, L, np.int32)

    sa32 = idx.sa.astype(np.int32)
    sa_masked = np.where(idx.pos_ok[sa32], sa32, np.int32(-1))
    full = idx.sa_kmers.astype(np.int64)
    lo_bits = 2 * k - 30
    t, q, nh, valid = find_anchors_wide(
        jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(sa_masked),
        jnp.asarray((full >> lo_bits).astype(np.int32)),
        jnp.asarray((full & ((1 << lo_bits) - 1)).astype(np.int32)),
        jnp.asarray(lut),
        k=k, max_hits_per_pos=8, max_anchors_per_read=256,
        lut_meta=(shift, max_steps),
    )
    t, q, nh, valid = (np.asarray(x) for x in (t, q, nh, valid))
    for b in range(B):
        got = {(int(tt), int(qq)) for tt, qq, v in zip(t[b], q[b], valid[b]) if v}
        want = set()
        for p in range(L - k + 1):
            kmer = codes[b, p : p + k]
            hits = [
                i for i in range(len(g) - k + 1)
                if np.array_equal(g[i : i + k], kmer)
            ]
            if 0 < len(hits) <= 8:
                want.update((h, p) for h in hits)
        assert got == want, f"read {b}: {len(got)} vs {len(want)} anchors"
