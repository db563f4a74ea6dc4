"""chain_stats: colinear-chain evidence per candidate window.

Oracle: brute-force over member anchors — the exact pair test for the
maxPValue admission gate (a >=2-anchor colinear non-overlapping chain
exists), and the exact predecessor-link count for the rank statistic.
"""

import numpy as np
import pytest


def brute_chain(t, q, valid, dstar, win, k):
    """Per window: (n_chain, chained_any) exactly as chain_stats defines
    them — n_chain = 1[any member] + #{j : exists member i with
    q_i <= q_j - k and t_i <= t_j - k}, chained_any = that set nonempty."""
    mem = [
        i for i in range(len(q))
        if valid[i] and 0 <= (t[i] - q[i]) - dstar < win
    ]
    n_link = 0
    for j in mem:
        if any(q[i] <= q[j] - k and t[i] <= t[j] - k for i in mem):
            n_link += 1
    return n_link + (1 if mem else 0), n_link > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_stats_matches_bruteforce(seed):
    import jax.numpy as jnp

    from blasr_jax.ops.candidates import chain_stats

    rng = np.random.default_rng(seed)
    B, A, C, k, win = 5, 40, 3, 14, 128
    G = 10_000
    q = rng.integers(0, 900, (B, A)).astype(np.int32)
    # half the anchors near a coherent diagonal per row, half scattered
    diag = rng.integers(0, G - 1000, (B, 1)).astype(np.int32)
    t = np.where(
        np.arange(A)[None, :] % 2 == 0,
        q + diag + rng.integers(0, win // 2, (B, A)),
        rng.integers(0, G, (B, A)),
    ).astype(np.int32)
    valid = rng.random((B, A)) > 0.2
    dstar = np.stack(
        [diag[:, 0], diag[:, 0] - 5, rng.integers(0, G, B)], axis=1
    ).astype(np.int32)
    cvalid = np.ones((B, C), bool)

    n_chain, chained_any, _mass, _corners = chain_stats(
        jnp.asarray(t), jnp.asarray(q), jnp.asarray(valid),
        jnp.asarray(dstar), jnp.asarray(cvalid), k=k, win=win,
    )
    n_chain = np.asarray(n_chain)
    chained_any = np.asarray(chained_any)
    for b in range(B):
        for c in range(C):
            exp_n, exp_any = brute_chain(
                t[b], q[b], valid[b], int(dstar[b, c]), win, k
            )
            assert n_chain[b, c] == exp_n, (b, c)
            assert chained_any[b, c] == exp_any, (b, c)


def test_chain_gate_rejects_scattered_window():
    """A window holding two anchors that cannot chain (t order opposes q
    order) must fail the admission gate; a true two-anchor chain passes."""
    import jax.numpy as jnp

    from blasr_jax.ops.candidates import chain_stats

    k, win = 14, 128
    # row 0: q 0 -> t 100, q 50 -> t 60 (t regresses): no chain
    # row 1: q 0 -> t 100, q 50 -> t 150: chains
    t = jnp.asarray([[100, 60], [100, 150]], jnp.int32)
    q = jnp.asarray([[0, 50], [0, 50]], jnp.int32)
    valid = jnp.ones((2, 2), bool)
    dstar = jnp.asarray([[40], [80]], jnp.int32)
    cvalid = jnp.ones((2, 1), bool)
    n_chain, chained_any, _mass, _corners = chain_stats(
        t, q, valid, dstar, cvalid, k=k, win=win
    )
    assert not bool(chained_any[0, 0])
    assert bool(chained_any[1, 0])
    assert int(n_chain[1, 0]) == 2


def test_invalid_candidate_has_no_chain():
    import jax.numpy as jnp

    from blasr_jax.ops.candidates import chain_stats

    t = jnp.asarray([[100, 150]], jnp.int32)
    q = jnp.asarray([[0, 50]], jnp.int32)
    valid = jnp.ones((1, 2), bool)
    dstar = jnp.asarray([[90]], jnp.int32)
    cvalid = jnp.zeros((1, 1), bool)
    n_chain, chained_any, _mass, _corners = chain_stats(
        t, q, valid, dstar, cvalid, k=14, win=128
    )
    assert int(n_chain[0, 0]) == 0
    assert not bool(chained_any[0, 0])


def test_mass_is_union_of_member_intervals():
    """chain_stats mass == union length of member [q, q+k) intervals
    (noOvpLisNBases role, FindMaxInterval.h:832), brute-force checked."""
    import jax.numpy as jnp
    import numpy as np

    from blasr_jax.ops.candidates import chain_stats

    rng = np.random.default_rng(7)
    B, A, C, k, win = 4, 24, 2, 14, 128
    q = rng.integers(0, 400, (B, A)).astype(np.int32)
    diag = rng.integers(0, 1000, (B, 1)).astype(np.int32)
    t = (q + diag + rng.integers(0, win // 2, (B, A))).astype(np.int32)
    valid = rng.random((B, A)) > 0.3
    dstar = np.stack([diag[:, 0], diag[:, 0] + 1000], axis=1).astype(np.int32)
    cvalid = np.ones((B, C), bool)

    _, _, mass, _ = chain_stats(
        jnp.asarray(t), jnp.asarray(q), jnp.asarray(valid),
        jnp.asarray(dstar), jnp.asarray(cvalid), k=k, win=win,
    )
    mass = np.asarray(mass)
    for b in range(B):
        for c in range(C):
            cover = np.zeros(2048, bool)
            for a in range(A):
                if valid[b, a] and 0 <= (t[b, a] - q[b, a]) - dstar[b, c] < win:
                    cover[q[b, a] : q[b, a] + k] = True
            assert mass[b, c] == int(cover.sum()), (b, c, mass[b, c], int(cover.sum()))


def test_min_interval_gate_rejects_bare_repeat_window(sim_factory=None):
    """A window whose only evidence is one short composed exact match (~17
    bases of anchor coverage) must be rejected by the default
    minInterval=100 admission gate (MappingParameters.h:348) — the
    reference never queues such intervals, so a free local DP must not
    emit records from them (the -bestn junk-secondary class)."""
    import numpy as np

    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.batching import Read
    from blasr_jax.io.seqdb import SeqDB
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping

    rng = np.random.default_rng(11)
    G = 60_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    # plant a 24-base exact copy of read positions 300..324 far away
    src, dst = 10_000, 40_000
    read = genome[src : src + 600].copy()
    genome[dst : dst + 24] = read[300:324]
    seqdb = SeqDB(["ref"], np.array([0, G], dtype=np.int64), ["0" * 32])
    index = build_index_from_arrays(genome, seqdb, k=14)
    params = MappingParams(
        batch_size=4, max_read_len=1024, n_candidates=4,
        n_dp_candidates=4, best_n=4,
    )
    records, unmapped = run_mapping(index, [Read("r", read, None, 0)], params)
    loci = sorted(r.tstart_fwd for r in records)
    assert any(abs(lo - src) < 50 for lo in loci), loci
    assert not any(abs(lo - dst) < 1000 for lo in loci), (
        f"bare 24-base-match window must not be emitted: {loci}"
    )


def test_global_chain_exact_vs_bruteforce():
    """global_chain_exact must equal exhaustive max-weight chain search
    (GlobalChain.h:100 semantics: predecessor's end <= successor's start in
    both coords, weight = length sum)."""
    import itertools

    import numpy as np

    from blasr_jax.ops.candidates import global_chain_exact

    rng = np.random.default_rng(3)
    for trial in range(40):
        n = int(rng.integers(1, 9))
        q = rng.integers(0, 60, n).astype(np.int64)
        t = rng.integers(0, 60, n).astype(np.int64)
        l = rng.integers(5, 20, n).astype(np.int64)
        best = 0
        for r in range(1, n + 1):
            for combo in itertools.permutations(range(n), r):
                ok = all(
                    q[combo[i]] + l[combo[i]] <= q[combo[i + 1]]
                    and t[combo[i]] + l[combo[i]] <= t[combo[i + 1]]
                    for i in range(r - 1)
                )
                if ok:
                    best = max(best, int(sum(l[c] for c in combo)))
        got, chain = global_chain_exact(q, t, l)
        assert got == best, (trial, got, best)
        # returned chain must be feasible and achieve the weight
        w = 0
        for i in range(len(chain)):
            w += int(l[chain[i]])
            if i:
                a, b = chain[i - 1], chain[i]
                assert q[a] + l[a] <= q[b] and t[a] + l[a] <= t[b]
        assert w == got


def test_chain_weight_device_matches_exact_oracle():
    """chain_weight_device (the on-device GlobalChain ranking) must equal
    global_chain_exact restricted to each window's members, with fragment
    length k (GlobalChain.h:100-210 semantics)."""
    import numpy as np
    import jax.numpy as jnp

    from blasr_jax.ops.candidates import (
        chain_weight_device, global_chain_exact,
    )

    rng = np.random.default_rng(17)
    B, A, C, k, win = 12, 48, 4, 14, 128
    for trial in range(8):
        t = rng.integers(0, 40_000, (B, A)).astype(np.int32)
        q = rng.integers(0, 800, (B, A)).astype(np.int32)
        # coherent clusters so windows have real chains
        for b in range(B):
            d0 = rng.integers(0, 30_000)
            sel = rng.choice(A, rng.integers(6, 20), replace=False)
            t[b, sel] = q[b, sel] + d0 + rng.integers(0, win, len(sel))
        valid = rng.random((B, A)) < 0.8
        dstar = np.zeros((B, C), np.int32)
        for b in range(B):
            dstar[b] = (t[b] - q[b])[rng.choice(A, C, replace=False)]
        cvalid = rng.random((B, C)) < 0.9

        got = np.asarray(chain_weight_device(
            jnp.asarray(t), jnp.asarray(q), jnp.asarray(valid),
            jnp.asarray(dstar), jnp.asarray(cvalid), k=k, win=win,
        ))
        for b in range(B):
            for c in range(C):
                if not cvalid[b, c]:
                    assert got[b, c] == 0
                    continue
                d = t[b] - q[b]
                m = valid[b] & (d - dstar[b, c] >= 0) & (d - dstar[b, c] < win)
                if not m.any():
                    assert got[b, c] == 0
                    continue
                w, _ = global_chain_exact(
                    q[b][m].astype(np.int64), t[b][m].astype(np.int64),
                    np.full(int(m.sum()), k, np.int64),
                )
                assert got[b, c] == w, (trial, b, c, got[b, c], w)
