"""BASELINE config-2 measurement: SAM soft-clip end-to-end throughput.

Config 2 = bench corpus mapped with SAM output (soft clipping), the
production output format. The reference comparison point is FASTA input
(this fork's FASTQ reader is broken — BASELINE.md) at 571 reads/s
single-thread. Convention matches bench.py: the warm pass compiles, the
timed pass measures steady state INCLUDING host SAM formatting and
writing.

Run: python scripts/bench_config2.py
"""

from __future__ import annotations

import io
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BENCH_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchdata")


def main() -> None:
    from blasr_jax.index.artifacts import load_index
    from blasr_jax.io.batching import read_records
    from blasr_jax.io.fasta import read_fasta
    from blasr_jax.io.sam import read_sam
    from blasr_jax.output.sam_writer import write_sam
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping

    genome_fa = os.path.join(BENCH_DIR, "genome.fasta")
    reads_fa = os.path.join(BENCH_DIR, "reads.fasta")
    if not os.path.exists(genome_fa):
        print("run bench.py once to build the corpus", file=sys.stderr)
        sys.exit(1)
    index = load_index(genome_fa, k=14)
    reads = read_records(reads_fa)
    genome = read_fasta(genome_fa)[0][1]
    params = MappingParams(
        batch_size=int(os.environ.get("BLASR_BENCH_B", "64")),
        max_read_len=int(os.environ.get("BLASR_BENCH_MAXL", "3328")),
        n_candidates=4,
        n_dp_candidates=int(os.environ.get("BLASR_BENCH_CD", "2")),
        anchor_stride=int(os.environ.get("BLASR_BENCH_STRIDE", "4")),
        max_anchors_per_read=int(os.environ.get("BLASR_BENCH_A", "128")),
        best_n=1,
    )

    def one_pass(out_path: str | None) -> float:
        t0 = time.time()
        records, unmapped = run_mapping(index, reads, params)
        buf = io.StringIO()
        write_sam(records, reads, index.seqdb, buf, clipping="soft",
                  unmapped=unmapped, genome=genome,
                  movie_name=os.path.basename(reads_fa))
        wall = time.time() - t0
        if out_path:
            with open(out_path, "w") as f:
                f.write(buf.getvalue())
        return wall

    one_pass(None)                       # warm: compile
    sam_path = "/tmp/bench_config2.sam"
    wall = one_pass(sam_path)

    # strict parse-back validation: our SAM must round-trip through the
    # framework's own strict reader (header + every record)
    sam = read_sam(sam_path)
    n_rec = sum(1 for r in sam.records if not r.is_unmapped)

    print(json.dumps({
        "metric": "reads_per_sec_config2_sam_softclip",
        "value": round(len(reads) / wall, 2),
        "unit": "reads/s",
        "vs_reference_singlethread": round(len(reads) / wall / 571.0, 2),
        "detail": {"wall_s": round(wall, 3), "n_reads": len(reads),
                   "sam_records": n_rec},
    }))


if __name__ == "__main__":
    main()
