"""QV-aware scoring (QualityValueScoreFunction role)."""

import numpy as np
import jax.numpy as jnp

from blasr_jax.ops.banded_align import AlignScores, banded_align, make_qoff

SC = AlignScores()


def run(q, t, qual=None):
    Q = jnp.asarray(q[None, :])
    Tc = jnp.asarray(t[None, :])
    qoff = jnp.asarray(make_qoff(len(q), len(t), 128, (len(t) - len(q)) // 2))
    qu = None if qual is None else jnp.asarray(qual[None, :])
    res = banded_align(
        Q, jnp.asarray([len(q)]), Tc, jnp.zeros(1, jnp.int32),
        jnp.asarray([len(t)]), qoff, qu, scores=SC,
    )
    return int(res.score[0])


def test_high_qual_mismatch_costs_more():
    rng = np.random.default_rng(0)
    t = rng.integers(0, 4, 80).astype(np.uint8)
    q = t[10:70].copy()
    q[30] = (q[30] + 1) % 4  # one mismatch
    base = run(q, t)                       # no QVs: mismatch 6
    hi = run(q, t, np.full(60, 30, np.uint8))   # qual 30 -> mismatch 12
    lo = run(q, t, np.full(60, 5, np.uint8))    # qual 5 -> mismatch 2
    mid = run(q, t, np.full(60, 15, np.uint8))  # qual 15 == unscaled
    assert mid == base
    assert hi == base + 6      # 12 instead of 6
    assert lo == base - 4      # 2 instead of 6


def test_low_qual_insertion_cheap():
    rng = np.random.default_rng(1)
    t = rng.integers(0, 4, 80).astype(np.uint8)
    q = np.insert(t[10:70].copy(), 30, (t[40] + 1) % 4)  # one inserted base
    base = run(q, t)
    qual = np.full(len(q), 15, np.uint8)
    qual[30] = 4               # the inserted base is marked low-quality
    cheap = run(q, t, qual)
    assert cheap < base        # insertion penalty 2 instead of 5


def test_fastq_end_to_end(tmp_path):
    """FASTQ reads map with QV-aware scoring through the full pipeline."""
    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.batching import Read, read_records
    from blasr_jax.io.seqdb import SeqDB
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping
    from blasr_jax.sim import simulate_genome, simulate_reads

    g = simulate_genome(40_000, seed=5, repeat_fraction=0.0)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    index = build_index_from_arrays(g, seqdb, k=13)
    reads, truth = simulate_reads(g, 6, mean_len=400, seed=6)
    # attach synthetic quals
    rng = np.random.default_rng(7)
    fq = tmp_path / "r.fastq"
    with open(fq, "w") as f:
        for r in reads:
            from blasr_jax.core.encode import codes_to_seq

            qual = rng.integers(8, 40, len(r.codes)).astype(np.uint8)
            f.write(f"@{r.name}\n{codes_to_seq(r.codes)}\n+\n")
            f.write((qual + 33).tobytes().decode() + "\n")
    rr = read_records(str(fq))
    assert rr[0].qual is not None
    params = MappingParams(
        batch_size=8, max_read_len=1024, n_candidates=2, best_n=1,
        min_match_length=13,
    )
    recs, unm = run_mapping(index, rr, params)
    assert not unm
    for rec, (start, end, strand) in zip(recs, truth):
        assert abs(rec.tstart_fwd - start) < 60
    # -ignoreQualities must give the plain-score result
    import dataclasses as dc

    recs2, _ = run_mapping(index, rr, dc.replace(params, ignore_qualities=True))
    recs3, _ = run_mapping(
        index, [Read(r.name, r.codes, None, r.index) for r in rr], params
    )
    for a, b in zip(recs2, recs3):
        assert a.score == b.score


def test_dual_stream_ids_scoring():
    """uint16 dual-phred stream (IDS role): low byte scales mismatches,
    high byte scales insertions, independently."""
    rng = np.random.default_rng(2)
    t = rng.integers(0, 4, 80).astype(np.uint8)
    q = t[10:70].copy()
    q[30] = (q[30] + 1) % 4  # one mismatch
    base = run(q, t)

    # sub stream hot (30), ins stream neutral (15): mismatch would cost 12,
    # so the optimal path re-routes through ins+del (5+5=10) -> +4. The
    # single-stream case scales BOTH (ins 10, mismatch 12 < 20) and keeps
    # the mismatch — exactly the asymmetry IDS scoring exists to express.
    dual = (np.full(60, 30, np.uint16)) | (np.uint16(15) << 8)
    assert run(q, t, dual) == base + 4

    # sub neutral, ins hot: mismatch unscaled (no insertions in this path)
    dual2 = (np.full(60, 15, np.uint16)) | (np.uint16(30) << 8)
    assert run(q, t, dual2) == base

    qi = np.insert(t[10:70].copy(), 30, (t[40] + 1) % 4)  # one insertion
    basei = run(qi, t)
    # ins stream cheap (5): insertion cost 5 -> 2
    dual3 = (np.full(61, 15, np.uint16)) | (np.uint16(5) << 8)
    assert run(qi, t, dual3) == basei - 3
