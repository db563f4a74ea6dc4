"""Benchmark: reads/s mapping simulated PacBio reads to an E. coli-scale genome.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Baseline (see BASELINE.md): the reference blasrmc mapped this corpus at
442 reads/s on one CPU thread (mapping only, precomputed SA); its 16-thread
figure is extrapolated linearly, 16 x 442 = 7072 reads/s. vs_baseline is
measured reads/s (full pipeline incl. host traceback + m4 formatting)
divided by that 16-thread estimate.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REFERENCE_16THREAD_READS_PER_S = 7072.0  # measured 442 r/s x 16 (see BASELINE.md)

BENCH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchdata")
GENOME_FA = os.path.join(BENCH_DIR, "genome.fasta")
READS_FA = os.path.join(BENCH_DIR, "reads.fasta")


def ensure_corpus():
    from blasr_jax.io.fasta import write_fasta
    from blasr_jax.sim import simulate_genome, simulate_reads

    os.makedirs(BENCH_DIR, exist_ok=True)
    if not os.path.exists(GENOME_FA):
        g = simulate_genome(4_600_000, seed=7)
        write_fasta(GENOME_FA, [("ref", g)])
    if not os.path.exists(READS_FA):
        from blasr_jax.io.fasta import read_fasta

        g = read_fasta(GENOME_FA)[0][1]
        reads, _ = simulate_reads(g, 2000, mean_len=1000, seed=11)
        write_fasta(READS_FA, [(r.name, r.codes) for r in reads])


def main():
    ensure_corpus()

    from blasr_jax.index.artifacts import load_index
    from blasr_jax.io.batching import read_records
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping
    from blasr_jax.sim import parse_truth

    t0 = time.time()
    index = load_index(GENOME_FA, k=14)
    t_index = time.time() - t0
    reads = read_records(READS_FA)
    params = MappingParams(
        # larger batches amortize per-dispatch fixed cost (bench detail
        # line: dispatch/wait/finalize split)
        batch_size=int(os.environ.get("BLASR_BENCH_B", "256")),
        max_read_len=int(os.environ.get("BLASR_BENCH_MAXL", "3328")),
        n_candidates=int(os.environ.get("BLASR_BENCH_NC", "4")),
        n_dp_candidates=int(os.environ.get("BLASR_BENCH_CD", "2")),
        anchor_stride=int(os.environ.get("BLASR_BENCH_STRIDE", "4")),
        max_anchors_per_read=int(os.environ.get("BLASR_BENCH_A", "128")),
        # W=32 measured lossless on this corpus (accuracy 0.983 at W=32/64,
        # golden m4 agreement unchanged).
        # narrow_band_max=3328 serves EVERY bucket with the narrow W=32
        # band; the band-escalation retry (params.band_escalation, on by
        # default) re-maps the few reads the narrow band visibly clips
        # through the guided wide band, which is what makes this operating
        # point safe on bursty-CLR error profiles (BASELINE.md round-4
        # narrow-band sweep + scripts/escalation_probe2.py).
        narrow_band=int(os.environ.get("BLASR_BENCH_W", "32")),
        guided_band=bool(int(os.environ.get("BLASR_BENCH_GUIDED", "0"))),
        narrow_band_max=int(os.environ.get("BLASR_BENCH_NBMAX", "3328")),
        best_n=1,
        # m4 serving: coordinates+stats only, no move strings to the host.
        # Same setting the -m 4 CLI uses (cli/blasr.py params_from_args).
        emit_moves=bool(int(os.environ.get("BLASR_BENCH_MOVES", "0"))),
        # adaptive candidate depth: output-identical to flat CD=2 and ~90%
        # of reads skip the second DP window, but the flagged-read re-map
        # sub-run has a fixed cost of its own. Off by default; its speed on
        # the GPU is not measured yet.
        adaptive_cd=bool(int(os.environ.get("BLASR_BENCH_ADAPTIVE", "0"))),
    )

    # serving operating point (env-overridable): top-2 windows DP'd per
    # read, every-4th-position seeding, 128 anchors per read-strand —
    # measured accuracy-neutral on this corpus (0.983 at stride 2/4/6/8,
    # CD=2 vs 3, A=512/256/128/64; the guard below keeps it honest) AND
    # against the reference golden m4 (98.00% raw, the same 40 repeat-tie
    # divergences as the conservative defaults; mapQV +-1 99.74%). The reference exposes the same speed/sensitivity
    # frontier through -nCandidates/-minMatch (README.md:53-58).
    # warmup: one full untimed pass. Compiles every (B, cap) program the
    # timed run dispatches (incl. post-spill-up caps), so the timed run
    # measures steady-state serving throughput — the same convention as the
    # reference baseline (mapping-only, precomputed index, warm process).
    t_w = time.time()
    _ = run_mapping(index, reads, params)
    warm_s = time.time() - t_w

    t0 = time.time()
    records, unmapped = run_mapping(index, reads, params)
    wall = time.time() - t0
    reads_per_s = len(reads) / wall
    from blasr_jax.pipeline import runner as _runner

    met = _runner.LAST_RUN_METRICS

    # accuracy guard: mapped to true location
    byname = {}
    for r in records:
        cur = byname.get(r.qname)
        if cur is None or r.score < cur.score:
            byname[r.qname] = r
    n_correct = 0
    for rd in reads:
        rec = byname.get(rd.name)
        if rec is None:
            continue
        start, end, strand = parse_truth(rd.name)
        if (
            rec.tstrand == strand
            and abs(rec.tstart_fwd - start) < 100
            and abs(rec.tend_fwd - end) < 100
        ):
            n_correct += 1
    accuracy = n_correct / len(reads)

    result = {
        "metric": "reads_per_sec_per_chip_ecoli_sim",
        "value": round(reads_per_s, 2),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_s / REFERENCE_16THREAD_READS_PER_S, 4),
    }
    print(json.dumps(result))
    print(
        json.dumps(
            {
                "detail": {
                    "n_reads": len(reads),
                    "wall_s": round(wall, 3),
                    "mapped": len(byname),
                    "accuracy_true_locus": round(accuracy, 4),
                    "unmapped": len(unmapped),
                    "index_load_s": round(t_index, 2),
                    "warm_pass_s": round(warm_s, 3),
                    "vs_singlethread_ref": round(reads_per_s / 442.0, 2),
                    "dispatch_s": round(met.dispatch_seconds, 3),
                    "wait_s": round(met.wait_seconds, 3),
                    "finalize_s": round(met.finalize_seconds, 3),
                    "n_batches": met.n_batches,
                }
            }
        ),
        file=sys.stderr,
    )
    # guard tight enough to catch a ~1% regression (steady-state accuracy
    # on this corpus is 0.982-0.983; VERDICT r4 asked for >= 0.975)
    if accuracy < 0.975:
        print(
            json.dumps({"warning": f"accuracy {accuracy:.3f} below 0.975"}),
            file=sys.stderr,
        )


if __name__ == "__main__":
    main()
