"""Sharded-index mapping must match the unsharded result (8-dev CPU mesh)."""

import numpy as np
import jax

from blasr_jax.index.artifacts import build_index_from_arrays
from blasr_jax.io.seqdb import SeqDB
from blasr_jax.params import MappingParams
from blasr_jax.parallel.sharded import make_shards, run_mapping_sharded
from blasr_jax.pipeline.runner import run_mapping
from blasr_jax.sim import simulate_genome, simulate_reads


def test_make_shards_cover_and_overlap():
    specs = make_shards(1000, 4, 100)
    assert [s.lo for s in specs] == [0, 250, 500, 750]
    assert [s.hi for s in specs] == [250, 500, 750, 1000]
    assert specs[1].block_lo == 150 and specs[1].block_hi == 600
    # ownership is a partition
    assert all(a.hi == b.lo for a, b in zip(specs, specs[1:]))


def test_sharded_matches_unsharded():
    g = simulate_genome(120_000, seed=21, repeat_fraction=0.0)
    seqdb = SeqDB(
        ["cA", "cB"], np.array([0, 70_000, 120_000], np.int64), ["0" * 32] * 2
    )
    reads, truth = simulate_reads(g, 24, mean_len=600, seed=3)
    params = MappingParams(
        batch_size=32, max_read_len=1024, n_candidates=2, best_n=1,
        min_match_length=13,
    )
    index = build_index_from_arrays(g, seqdb, k=13)
    ref_recs, ref_unm = run_mapping(index, reads, params)
    sh_recs, sh_unm = run_mapping_sharded(
        g, seqdb, reads, params, n_shards=4, k=13, devices=jax.devices()[:4]
    )
    assert sh_unm == ref_unm == []
    ref_by = {r.qname: r for r in ref_recs}
    sh_by = {r.qname: r for r in sh_recs}
    assert set(ref_by) == set(sh_by)
    n_same = 0
    for name, a in ref_by.items():
        b = sh_by[name]
        assert a.tname == b.tname, name
        assert a.tstrand == b.tstrand, name
        # same locus; scores may differ slightly only for boundary reads
        assert abs(a.tstart_fwd - b.tstart_fwd) < 100, name
        if (a.tstart, a.tend, a.score) == (b.tstart, b.tend, b.score):
            n_same += 1
    assert n_same >= len(ref_by) - 2  # at most a couple of boundary reads


def test_multihost_parts_merge_to_single_host_output(tmp_path):
    """2 simulated hosts' part files merge to the 1-host m4 (order + content)."""
    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.output.m4 import format_m4
    from blasr_jax.parallel.multihost import (
        host_shard, init_distributed, merge_host_parts, run_mapping_host_part,
    )

    pid, n = init_distributed()
    assert (pid, n) == (0, 1)

    g = simulate_genome(60_000, seed=61, repeat_fraction=0.0)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    index = build_index_from_arrays(g, seqdb, k=13)
    reads, _ = simulate_reads(g, 20, mean_len=400, seed=62)
    params = MappingParams(
        batch_size=16, max_read_len=1024, n_candidates=2, best_n=1,
        min_match_length=13,
    )
    # simulate two hosts in-process
    prefix = str(tmp_path / "mh")
    for pid_ in range(2):
        run_mapping_host_part(index, reads, params, prefix, pid_, 2)
    merged = str(tmp_path / "merged.m4")
    n_rec = merge_host_parts(prefix, merged)

    ref_recs, _ = run_mapping(index, reads, params)
    ref_lines = [format_m4(r) for r in ref_recs]
    got_lines = open(merged).read().strip().split("\n")
    assert n_rec == len(ref_lines)
    assert got_lines == ref_lines  # identical records in identical order
    # shards are a partition
    s0 = {r.name for r in host_shard(reads, 0, 2)}
    s1 = {r.name for r in host_shard(reads, 1, 2)}
    assert not (s0 & s1) and len(s0 | s1) == len(reads)


def test_multihost_sam_parts_merge(tmp_path):
    """SAM part files (headerless, index-tagged) merge with a single header
    to the 1-host write_sam output byte-for-byte."""
    import io

    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.output.sam_writer import sam_header, write_sam
    from blasr_jax.parallel.multihost import (
        merge_host_parts, run_mapping_host_part,
    )

    g = simulate_genome(60_000, seed=71, repeat_fraction=0.0)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    index = build_index_from_arrays(g, seqdb, k=13)
    reads, _ = simulate_reads(g, 16, mean_len=400, seed=72)
    params = MappingParams(
        batch_size=16, max_read_len=1024, n_candidates=2, best_n=1,
        min_match_length=13,
    )
    prefix = str(tmp_path / "mhs")
    unmapped_all: list[str] = []
    for pid_ in range(2):
        _, unm = run_mapping_host_part(
            index, reads, params, prefix, pid_, 2, fmt="sam",
            movie_name="reads.fa",
        )
        unmapped_all.extend(unm)
    merged = str(tmp_path / "merged.sam")
    merge_host_parts(
        prefix, merged, num_processes=2,
        header_lines=sam_header(seqdb, "blasr_jax", ["reads.fa"]),
    )

    ref_recs, ref_unm = run_mapping(index, reads, params)
    buf = io.StringIO()
    write_sam(ref_recs, reads, seqdb, buf, program_line="blasr_jax",
              unmapped=ref_unm, movie_name="reads.fa", genome=index.genome)
    got = open(merged).read()
    assert got == buf.getvalue()


def test_routed_sharded_equals_broadcast(tmp_path):
    """route=True (canonical-k-mer sketch prefilter) produces the same
    output as broadcasting every read to every shard, and actually prunes
    shard visits on a non-repetitive genome."""
    from blasr_jax.parallel.sharded import (
        build_shard_sketch, make_shards, route_reads, run_mapping_sharded,
    )

    g = simulate_genome(120_000, seed=77, repeat_fraction=0.0)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    reads, _ = simulate_reads(g, 24, mean_len=600, seed=78)
    params = MappingParams(
        batch_size=16, max_read_len=1024, n_candidates=2, best_n=1,
        min_match_length=13,
    )
    a, ua = run_mapping_sharded(g, seqdb, reads, params, n_shards=3, k=13)
    b, ub = run_mapping_sharded(
        g, seqdb, reads, params, n_shards=3, k=13, route=True
    )
    fmt = lambda rs: sorted(
        (r.qname, r.tname, r.tstrand, r.tstart, r.tend, r.score) for r in rs
    )
    assert fmt(a) == fmt(b)
    assert sorted(ua) == sorted(ub)

    # the router prunes: on this non-repetitive genome most reads route to
    # a single shard
    overlap = params.max_read_len + params.target_pad
    specs = make_shards(len(g), 3, overlap)
    sketches = [
        build_shard_sketch(g[sp.block_lo : sp.block_hi]) for sp in specs
    ]
    routes = route_reads(reads, sketches)
    visits = sum(len(rt) for rt in routes)
    assert visits < 2 * len(reads), visits


def test_sharded_server_serves_repeatedly(tmp_path):
    """ShardedServer: indexes built once, repeated map() calls agree with
    the one-shot path."""
    from blasr_jax.parallel.sharded import ShardedServer, run_mapping_sharded

    g = simulate_genome(90_000, seed=87, repeat_fraction=0.0)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    params = MappingParams(
        batch_size=16, max_read_len=1024, n_candidates=2, best_n=1,
        min_match_length=13,
    )
    srv = ShardedServer(g, seqdb, params, n_shards=2, k=13)
    for seed in (91, 92):
        reads, _ = simulate_reads(g, 12, mean_len=500, seed=seed)
        a, ua = srv.map(reads)
        b, ub = run_mapping_sharded(
            g, seqdb, reads, params, n_shards=2, k=13
        )
        fmt = lambda rs: sorted(
            (r.qname, r.tstart, r.tend, r.score) for r in rs
        )
        assert fmt(a) == fmt(b) and sorted(ua) == sorted(ub)


import pytest


@pytest.mark.parametrize("fmt", ["m0", "m1", "m2", "m3", "m5"])
def test_multihost_verbose_parts_merge(tmp_path, fmt):
    """m0/m1/m2/m3/m5 part files (newline-escaped blocks) merge to the
    1-host write_verbose output byte-for-byte."""
    import io

    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.output.verbose import write_verbose
    from blasr_jax.parallel.multihost import (
        merge_host_parts, run_mapping_host_part,
    )

    g = simulate_genome(50_000, seed=81, repeat_fraction=0.0)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    index = build_index_from_arrays(g, seqdb, k=13)
    reads, _ = simulate_reads(g, 12, mean_len=300, seed=82)
    params = MappingParams(
        batch_size=16, max_read_len=512, n_candidates=2, best_n=1,
        min_match_length=13,
    )
    prefix = str(tmp_path / f"mh{fmt}")
    for pid_ in range(2):
        run_mapping_host_part(index, reads, params, prefix, pid_, 2, fmt=fmt)
    merged = str(tmp_path / f"merged.{fmt}")
    merge_host_parts(prefix, merged, num_processes=2)

    ref_recs, _ = run_mapping(index, reads, params)
    buf = io.StringIO()
    write_verbose(ref_recs, reads, index, buf, fmt=int(fmt[1]))
    assert open(merged).read() == buf.getvalue()


def test_merge_breaks_score_ties_like_one_index():
    """Equal-score records of one read from different shards rank as the
    unsharded selection ranks them: by the start in the strand's reported
    coordinate space (forward start on strand 0, genome length minus the
    forward end on strand 1)."""
    import functools

    from blasr_jax.io.seqdb import SeqDB
    from blasr_jax.parallel.sharded import _merge_key
    from blasr_jax.pipeline.runner import AlignmentRecord

    db = SeqDB(["a", "b"], np.array([0, 1000, 3000]), ["0" * 32] * 2)

    def rec(score, strand, contig, ts):
        return AlignmentRecord(
            qname="r", tname=db.names[contig], score=score, pct_similarity=90.0,
            qstrand=0, qstart=0, qend=100, qlength=100, tstrand=strand,
            tstart=0, tend=0, tlength=0, mapqv=0, contig_index=contig,
            tstart_fwd=ts, tend_fwd=ts + 100,
        )

    key = functools.partial(_merge_key, seqdb=db)
    fwd = [rec(-300, 0, 1, 50), rec(-300, 0, 0, 700), rec(-400, 0, 1, 900)]
    assert [(r.contig_index, r.tstart_fwd) for r in sorted(fwd, key=key)] == [
        (1, 900), (0, 700), (1, 50)]
    rc = [rec(-300, 1, 0, 100), rec(-300, 1, 1, 1500), rec(-300, 1, 0, 800)]
    assert [(r.contig_index, r.tstart_fwd) for r in sorted(rc, key=key)] == [
        (1, 1500), (0, 800), (0, 100)]
