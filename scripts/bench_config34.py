"""BASELINE configs 3 and 4: -bestn 2 -m 5 and the BWT-FM serving path.

Config 3 = precomputed index + ``-bestn 2`` multi-hit reporting with -m 5
output (reference ``configs[2]``): exercises the secondary-emission path
(host SDP admission rescore, pipeline/secondary_refine.py) plus full m5
string formatting (alignment strings replayed from device move words).

Config 4 = the BWT-FM anchor path (reference ``configs[3]``, ``-bwt``):
same mapping program but anchors come from ops/fm_search.find_anchors_fm
(backward search over the device FM index) instead of the SA searchsorted
path. Anchor-set equality with the SA path is tested (tests/test_fm.py);
this script times it.

Convention matches bench.py: the warm pass compiles, the timed pass
measures steady state including host formatting.

Run: python scripts/bench_config34.py
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
    from blasr_jax.index.fm import build_fm_index
    from blasr_jax.io.batching import read_records
    from blasr_jax.output.verbose import format_m5
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping

    genome_fa = os.path.join(BENCH_DIR, "genome.fasta")
    reads_fa = os.path.join(BENCH_DIR, "reads.fasta")
    if not os.path.exists(genome_fa):
        print("run bench.py once to build the corpus", file=sys.stderr)
        sys.exit(1)
    index = load_index(genome_fa, k=14)
    reads = read_records(reads_fa)
    byname = {r.name: r for r in reads}
    base = dict(
        batch_size=int(os.environ.get("BLASR_BENCH_B", "256")),
        max_read_len=int(os.environ.get("BLASR_BENCH_MAXL", "3328")),
        n_candidates=4,
        n_dp_candidates=int(os.environ.get("BLASR_BENCH_CD", "2")),
        anchor_stride=int(os.environ.get("BLASR_BENCH_STRIDE", "4")),
        max_anchors_per_read=int(os.environ.get("BLASR_BENCH_A", "128")),
        narrow_band=int(os.environ.get("BLASR_BENCH_W", "32")),
        narrow_band_max=int(os.environ.get("BLASR_BENCH_NBMAX", "3328")),
    )
    out = {}

    # ---- config 3: -bestn 2, -m 5 ----
    p3 = MappingParams(best_n=2, **base)

    def pass3() -> tuple[float, int]:
        t0 = time.time()
        records, _ = run_mapping(index, reads, p3)
        buf = io.StringIO()
        for rec in records:
            buf.write(format_m5(rec, byname[rec.qname], index))
            buf.write("\n")
        return time.time() - t0, len(records)

    pass3()
    wall3, nrec3 = pass3()
    out["config3_bestn2_m5"] = {
        "reads_per_s": round(len(reads) / wall3, 2),
        "wall_s": round(wall3, 3),
        "records": nrec3,
    }
    print(json.dumps({"config3_bestn2_m5": out["config3_bestn2_m5"]}),
          flush=True)

    # ---- config 4: BWT-FM anchor path, -m 4 ----
    from blasr_jax.index.suffix_array import build_suffix_array

    t0 = time.time()
    fm = build_fm_index(index.genome, build_suffix_array(index.genome))
    fm_build_s = time.time() - t0
    # the FM working set (BWT rows + sampled SA + backward-search state at
    # 2B strands) exceeds HBM at B=256 (measured: 23.5G of 15.75G) — the
    # low-memory path serves at B=64, the reference configuration's point
    base4 = dict(base, batch_size=int(os.environ.get("BLASR_BENCH_B4", "64")))
    p4 = MappingParams(best_n=1, emit_moves=False, **base4)

    def pass4() -> tuple[float, int]:
        t0 = time.time()
        records, _ = run_mapping(index, reads, p4, fm=fm)
        from blasr_jax.output.m4 import format_m4

        buf = io.StringIO()
        for rec in records:
            buf.write(format_m4(rec))
            buf.write("\n")
        return time.time() - t0, len(records)

    pass4()
    wall4, nrec4 = pass4()
    out["config4_fm_bwt_m4"] = {
        "reads_per_s": round(len(reads) / wall4, 2),
        "wall_s": round(wall4, 3),
        "records": nrec4,
        "fm_build_s": round(fm_build_s, 2),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
