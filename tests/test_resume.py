"""Batch-granular checkpoint/resume of the mapping run."""

import json
import os

import numpy as np

from blasr_jax.cli.blasr import main as blasr_main
from blasr_jax.io.fasta import write_fasta
from blasr_jax.sim import simulate_genome, simulate_reads


def _corpus(tmp_path, n=40):
    g = simulate_genome(60_000, seed=51, repeat_fraction=0.0)
    gp = str(tmp_path / "g.fa")
    write_fasta(gp, [("ref", g)])
    reads, _ = simulate_reads(g, n, mean_len=400, seed=52)
    rp = str(tmp_path / "r.fa")
    write_fasta(rp, [(r.name, r.codes) for r in reads])
    return rp, gp


def test_resume_continues_where_left(tmp_path):
    rp, gp = _corpus(tmp_path)
    out = str(tmp_path / "o.m4")
    common = [rp, gp, "-m", "4", "-out", out, "-resume",
              "-batchSize", "8", "-maxReadLen", "1024", "-minMatch", "13"]
    # full run as reference
    ref_out = str(tmp_path / "ref.m4")
    blasr_main([rp, gp, "-m", "4", "-out", ref_out,
                "-batchSize", "8", "-maxReadLen", "1024", "-minMatch", "13"])
    # fresh resumable run
    blasr_main(common)
    manifest = json.load(open(out + ".resume.json"))
    n_batches = manifest["batches_done"]
    assert n_batches >= 5
    full = sorted(open(out).read().strip().split("\n"))

    # simulate preemption: rewind manifest + truncate output to 2 batches
    lines = open(out).read().strip().split("\n")
    # count records of first 2 batches by re-running with hook? simpler:
    # truncate to the manifest of 2 and drop the file tail accordingly is
    # not reconstructible here — instead just rerun from batch 2 and check
    # no duplicates/missing vs the full set modulo the first 2 batches.
    manifest["batches_done"] = 2
    json.dump(manifest, open(out + ".resume.json", "w"))
    keep = []
    seen_batches = 0
    # deterministic batching: first 2 batches = first 16 reads of the
    # 1024-bucket ordering; emulate by keeping records of those reads
    from blasr_jax.io.batching import batch_reads, read_records

    reads = read_records(rp)
    batches = list(batch_reads(reads, 8, 1024))
    first2 = {n for b in batches[:2] for n in b.names if n}
    # m4 qnames carry the reference /0_<len> whole-read suffix
    keep = [l for l in lines if l.split()[0].rpartition("/")[0] in first2]
    open(out, "w").write("\n".join(keep) + "\n")

    blasr_main(common)
    resumed = sorted(open(out).read().strip().split("\n"))
    assert resumed == full  # nothing missing, nothing duplicated


def _burst_corpus(tmp_path):
    """Corpus where the narrow band visibly clips: clean reads plus two
    1.2 kb reads carrying a 150-base insertion burst (the band-escalation
    trigger shape, cf. tests/test_e2e.py escalation test)."""
    g = simulate_genome(120_000, seed=61, repeat_fraction=0.0)
    gp = str(tmp_path / "g.fa")
    write_fasta(gp, [("ref", g)])
    reads, _ = simulate_reads(g, 14, mean_len=800, seed=62)
    reads = list(reads)
    rng = np.random.default_rng(63)
    from blasr_jax.io.batching import Read

    for i, t0 in enumerate((30_000, 70_000)):
        tpl = g[t0 : t0 + 1200]
        burst = rng.integers(0, 4, 150).astype(np.uint8)
        q = np.concatenate([tpl[:600], burst, tpl[600:]])
        reads.append(Read(f"burst/{i}|ref|{t0}|{t0 + 1200}|0", q, None, 100 + i))
    rp = str(tmp_path / "r.fa")
    write_fasta(rp, [(r.name, r.codes) for r in reads])
    return rp, gp, reads


def test_streamed_equals_inmemory_with_escalation(tmp_path):
    """Streamed (on_batch) output must equal the in-memory return when the
    band-escalation retry replaces records (round-4 divergence: streaming
    consumers kept the inferior pre-escalation record). Record-set
    equality, not byte order: deferred reads are delivered in the final
    on_batch(-1, ...) call after the retries resolve."""
    from blasr_jax.index.artifacts import load_index
    from blasr_jax.io.batching import read_records
    from blasr_jax.output.m4 import format_m4
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping

    rp, gp, _ = _burst_corpus(tmp_path)
    index = load_index(gp, k=13)
    reads = read_records(rp)
    params = MappingParams(
        batch_size=8, max_read_len=1536, n_candidates=2, best_n=1,
        min_match_length=13, narrow_band=32, narrow_band_max=1536,
    )
    recs_plain, unm_plain = run_mapping(index, reads, params)

    streamed: list = []
    streamed_unm: list = []

    def on_batch(bi, recs, unm):  # 3-arg consumer (no manifest support)
        streamed.extend(recs)
        streamed_unm.extend(unm)

    recs_mem, unm_mem = run_mapping(index, reads, params, on_batch=on_batch)
    # escalation must actually fire on this corpus for the test to bite
    assert any(r.qname.startswith("burst") for r in recs_mem)
    assert sorted(format_m4(r) for r in recs_mem) == sorted(
        format_m4(r) for r in recs_plain
    )
    # THE invariant: streamed record set == in-memory record set
    assert sorted(format_m4(r) for r in streamed) == sorted(
        format_m4(r) for r in recs_mem
    )
    assert sorted(streamed_unm) == sorted(unm_mem)


def test_resume_streams_escalated_records(tmp_path):
    """CLI -resume output equals the plain run's output (sorted lines) on a
    corpus where escalation replaces records, and an interrupted run with
    pending deferred reads recovers them on resume."""
    rp, gp, reads = _burst_corpus(tmp_path)
    flags = ["-m", "4", "-batchSize", "8", "-maxReadLen", "1536",
             "-minMatch", "13", "-bandSize", "16", "-nCandidates", "2"]
    plain_out = str(tmp_path / "plain.m4")
    blasr_main([rp, gp, "-out", plain_out] + flags)
    out = str(tmp_path / "o.m4")
    blasr_main([rp, gp, "-out", out, "-resume"] + flags)
    plain = sorted(open(plain_out).read().strip().split("\n"))
    resumed = sorted(open(out).read().strip().split("\n"))
    assert resumed == plain
    manifest = json.load(open(out + ".resume.json"))
    assert manifest.get("deferred") == []  # all resolved by run end

    # simulate a preemption AFTER the burst reads' batch flushed but BEFORE
    # the escalation retry resolved: manifest says all batches done but the
    # burst reads are still pending; their records are absent from disk
    burst_names = [r.name for r in reads if r.name.startswith("burst")]
    assert burst_names
    lines = open(out).read().strip().split("\n")
    kept = [
        l for l in lines
        if l.split()[0].rpartition("/")[0] not in set(burst_names)
    ]
    open(out, "w").write("\n".join(kept) + "\n")
    manifest["deferred"] = burst_names
    json.dump(manifest, open(out + ".resume.json", "w"))
    blasr_main([rp, gp, "-out", out, "-resume"] + flags)
    resumed2 = sorted(open(out).read().strip().split("\n"))
    assert resumed2 == plain
    manifest2 = json.load(open(out + ".resume.json"))
    assert manifest2.get("deferred") == []
