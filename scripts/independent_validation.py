"""Independent-corpus validation (closing the simulator-closed-loop gap).

Every accuracy number so far was measured on reads from this repo's own
simulator, with the operating point tuned on that same simulator. This
script re-measures accuracy, golden agreement and the CD/stride operating
point on a corpus drawn from an error model built from PUBLISHED PacBio
CLR statistics (ErrorModel.published_clr(): the BLASR paper's ~11% ins /
3.4% del / 1.4% sub with cognate-insertion and homopolymer-deletion
context effects) — numbers the pipeline was never tuned against, playing
the role of the reference's empirical alchemy models
(reference simulator/Alchemy.cpp:43+, OutputSampleListSet.h).

Usage:
  python scripts/independent_validation.py            # ours, both operating points
  python scripts/independent_validation.py --golden   # also run reference blasrmc + compare

Reference binary expected at /tmp/refbuild/alignment/bin/blasrmc (see
CLAUDE.md build recipe); --golden skips gracefully if absent.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

BENCH_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchdata")
GENOME_FA = os.path.join(BENCH_DIR, "genome.fasta")
READS_FA = os.path.join(BENCH_DIR, "independent_reads.fasta")
REF_BIN = "/tmp/refbuild/alignment/bin/blasrmc"
REF_SAW = "/tmp/refbuild/alignment/bin/sawritermc"


def ensure_corpus() -> None:
    from blasr_jax.io.fasta import read_fasta, write_fasta
    from blasr_jax.sim import ErrorModel, simulate_genome, simulate_reads_alchemy

    os.makedirs(BENCH_DIR, exist_ok=True)
    if not os.path.exists(GENOME_FA):
        g = simulate_genome(4_600_000, seed=7)
        write_fasta(GENOME_FA, [("ref", g)])
    if not os.path.exists(READS_FA):
        g = read_fasta(GENOME_FA)[0][1]
        model = ErrorModel.published_clr()
        t0 = time.time()
        reads, _ = simulate_reads_alchemy(g, model, 2000, seed=23)
        print(f"corpus: 2000 published-CLR reads in {time.time()-t0:.0f}s",
              file=sys.stderr)
        write_fasta(READS_FA, [(r.name, r.codes) for r in reads])


def accuracy_of(records, reads) -> float:
    from blasr_jax.sim import parse_truth

    byname = {}
    for r in records:
        cur = byname.get(r.qname)
        if cur is None or r.score < cur.score:
            byname[r.qname] = r
    n_ok = 0
    for rd in reads:
        rec = byname.get(rd.name)
        if rec is None:
            continue
        start, end, strand = parse_truth(rd.name)
        if (rec.tstrand == strand and abs(rec.tstart_fwd - start) < 100
                and abs(rec.tend_fwd - end) < 100):
            n_ok += 1
    return n_ok / len(reads)


def run_ours() -> dict:
    from blasr_jax.index.artifacts import load_index
    from blasr_jax.io.batching import read_records
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping

    index = load_index(GENOME_FA, k=14)
    reads = read_records(READS_FA)
    out = {}
    points = {
        "bench(CD=2,stride=4,A=128)": dict(n_dp_candidates=2, anchor_stride=4,
                                           max_anchors_per_read=128),
        "conservative(CD=3,stride=1)": dict(n_dp_candidates=3, anchor_stride=1),
    }
    for name, kw in points.items():
        params = MappingParams(batch_size=64, max_read_len=3328,
                               n_candidates=4, best_n=1, **kw)
        _ = run_mapping(index, reads, params)          # warm/compile pass
        t0 = time.time()
        records, unmapped = run_mapping(index, reads, params)
        wall = time.time() - t0
        out[name] = {
            "accuracy_true_locus": round(accuracy_of(records, reads), 4),
            "reads_per_s": round(len(reads) / wall, 1),
            "unmapped": len(unmapped),
        }
        print(json.dumps({name: out[name]}), file=sys.stderr)
    return out


def run_reference() -> str | None:
    if not os.path.exists(REF_BIN):
        print("reference binary missing; skipping golden", file=sys.stderr)
        return None
    sa = GENOME_FA + ".refsa"
    if not os.path.exists(sa):
        subprocess.run([REF_SAW, sa, GENOME_FA], check=True)
    ref_m4 = os.path.join(BENCH_DIR, "independent_ref.m4")
    if not os.path.exists(ref_m4):
        t0 = time.time()
        subprocess.run(
            [REF_BIN, READS_FA, GENOME_FA, "-sa", sa, "-m", "4",
             "-out", ref_m4, "-bestn", "1", "-nproc", "4"],
            check=True)
        print(f"reference blasrmc: {time.time()-t0:.0f}s", file=sys.stderr)
    return ref_m4


def main() -> None:
    ensure_corpus()
    ours = run_ours()
    result = {"independent_corpus": ours}
    if "--golden" in sys.argv:
        ref_m4 = run_reference()
        if ref_m4:
            ours_m4 = os.path.join(BENCH_DIR, "independent_ours.m4")
            subprocess.run(
                [sys.executable, "-m", "blasr_jax.cli.blasr", READS_FA,
                 GENOME_FA, "-m", "4", "-out", ours_m4, "-bestn", "1"],
                check=True,
                cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
            cmp_out = subprocess.run(
                [sys.executable, "scripts/compare_golden.py", ours_m4, ref_m4],
                capture_output=True, text=True,
                cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
            print(cmp_out.stdout, file=sys.stderr)
            result["golden"] = cmp_out.stdout.strip().splitlines()[-3:]
    print(json.dumps(result))


if __name__ == "__main__":
    main()
