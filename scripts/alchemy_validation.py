"""Validation on a corpus generated by the REFERENCE'S OWN simulator.

Round-3 verdict item: every corpus so far came from this repo's simulator.
This script measures accuracy + golden agreement on reads generated by the
reference's alchemy binary (built from /root/reference/simulator with the
HDF5 writer stubbed out — FASTA mode never reaches it), driven by an error
model written at published CLR rates (scripts/make_alchemy_model.py). The
read generation machinery — context sampling, emission replay, length
model — is therefore the reference's, not ours.

Setup (once, outside the repo):
  cd /tmp/refbuild/simulator && mkdir -p bin && make alchemy; g++ -O3 \
      bin/Alchemy.o -o bin/alchemy -lpthread -lrt
  (see BASELINE.md "alchemy corpus" section for the stub + title patch)
  python scripts/make_alchemy_model.py /tmp/clr.model 5
  /tmp/refbuild/simulator/bin/alchemy /tmp/clr.model \
      -genome benchdata/genome.fasta -basesPerFile 2M
  -> /tmp/m000000_000000_00000_cSIMULATED_s.0.fasta
     (titles carry |seqIndex|seqPos truth via the container-local patch)

Run: python scripts/alchemy_validation.py [--golden]
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

READS_FA = "/tmp/m000000_000000_00000_cSIMULATED_s.0.fasta"
GENOME_FA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "benchdata", "genome.fasta",
)
REF_BIN = "/tmp/refbuild/alignment/bin/blasrmc"
REF_SA = "/tmp/genome.sa"


def main() -> None:
    if not os.path.exists(READS_FA):
        print(f"missing {READS_FA} — see module docstring", file=sys.stderr)
        sys.exit(1)
    from blasr_jax.index.artifacts import load_index
    from blasr_jax.io.batching import read_records
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping

    index = load_index(GENOME_FA, k=14)
    reads = read_records(READS_FA)
    params = MappingParams(
        batch_size=64, max_read_len=3328, n_candidates=4,
        n_dp_candidates=2, anchor_stride=4, max_anchors_per_read=128,
        narrow_band=int(os.environ.get("BLASR_BENCH_W", "32")),
        narrow_band_max=int(os.environ.get("BLASR_BENCH_NBMAX", "1536")),
        best_n=1,
    )
    _ = run_mapping(index, reads, params)  # warm
    t0 = time.time()
    records, unmapped = run_mapping(index, reads, params)
    wall = time.time() - t0

    best = {}
    for r in records:
        if r.qname not in best or r.score < best[r.qname].score:
            best[r.qname] = r
    n_ok = 0
    for rd in reads:
        # title: movie/i/0_len|seqIndex|seqPos (fwd strand by construction)
        parts = rd.name.split("|")
        truth = int(parts[2])
        rec = best.get(rd.name)
        if rec is not None and rec.tstrand == 0 and abs(rec.tstart_fwd - truth) < 100:
            n_ok += 1
    acc = n_ok / len(reads)
    print(f"ours: {len(reads)} reads, {len(reads)/wall:.0f} reads/s, "
          f"mapped {len(reads) - len(unmapped)}, accuracy_true_locus {acc:.4f}")

    if "--golden" in sys.argv and os.path.exists(REF_BIN):
        ours_m4 = "/tmp/alchemy_ours.m4"
        from blasr_jax.output.m4 import write_m4

        with open(ours_m4, "w") as f:
            write_m4(records, f)
        ref_m4 = "/tmp/alchemy_ref.m4"
        subprocess.run(
            [REF_BIN, READS_FA, GENOME_FA, "-sa", REF_SA, "-m", "4",
             "-bestn", "1", "-out", ref_m4],
            check=True, timeout=3600,
        )
        # reference accuracy on the same corpus
        n_ref_ok = 0
        n_ref = 0
        for ln in open(ref_m4):
            f_ = ln.split()
            n_ref += 1
            # blasrmc appends its own /0_<len> subread suffix after our
            # |seqPos field
            truth = int(f_[0].split("|")[2].split("/")[0])
            if int(f_[8]) == 0 and abs(int(f_[9]) - truth) < 100:
                n_ref_ok += 1
        print(f"reference: {n_ref} records, accuracy {n_ref_ok/max(n_ref,1):.4f}")
        cmp = subprocess.run(
            [sys.executable, "scripts/compare_golden.py", ours_m4, ref_m4],
            capture_output=True, text=True,
        )
        print(cmp.stdout.strip())


if __name__ == "__main__":
    main()
