"""Part 2 of the band-escalation design probe: isolate the reads the
narrow-everywhere band (W=32, NBMAX=3328) NEWLY breaks relative to the
default length-scaled band, and find their narrow-pass signature — those
are the reads a retry trigger must catch."""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

BENCH_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchdata"
)
GENOME_FA = os.path.join(BENCH_DIR, "genome.fasta")
READS_FA = os.path.join(BENCH_DIR, "independent_reads.fasta")


def run(params, index, reads):
    from blasr_jax.pipeline.runner import run_mapping
    from blasr_jax.sim import parse_truth

    t0 = time.time()
    records, unmapped = run_mapping(index, reads, params)
    wall = time.time() - t0
    byname = {}
    for r in records:
        cur = byname.get(r.qname)
        if cur is None or r.score < cur.score:
            byname[r.qname] = r
    res = {}
    for rd in reads:
        rec = byname.get(rd.name)
        start, end, strand = parse_truth(rd.name)
        if rec is None:
            res[rd.name] = (0, 0.0, 0.0, 0.0, len(rd.codes))
            continue
        ok = int(
            rec.tstrand == strand
            and abs(rec.tstart_fwd - start) < 100
            and abs(rec.tend_fwd - end) < 100
        )
        qcov = (rec.qend - rec.qstart) / max(rec.qlength, 1)
        spb = rec.score / max(rec.qend - rec.qstart, 1)
        res[rd.name] = (ok, qcov, rec.pct_similarity, spb, rec.qlength)
    return res, wall


def main() -> None:
    import dataclasses

    from blasr_jax.index.artifacts import load_index
    from blasr_jax.io.batching import read_records
    from blasr_jax.params import MappingParams

    index = load_index(GENOME_FA, k=14)
    reads = read_records(READS_FA)
    base = MappingParams(
        batch_size=64, max_read_len=3328, n_candidates=4, n_dp_candidates=2,
        anchor_stride=4, max_anchors_per_read=128,
        narrow_band=32, narrow_band_max=1536, best_n=1,
    )
    narrow = dataclasses.replace(base, narrow_band_max=3328)
    res_d, wall_d = run(base, index, reads)
    print(f"default: {wall_d:.1f}s", file=sys.stderr)
    res_n, wall_n = run(narrow, index, reads)
    print(f"narrow:  {wall_n:.1f}s", file=sys.stderr)

    acc_d = np.mean([v[0] for v in res_d.values()])
    acc_n = np.mean([v[0] for v in res_n.values()])
    print(f"default acc {acc_d:.4f} | narrow-everywhere acc {acc_n:.4f}")
    victims = [
        n for n in res_d
        if res_d[n][0] == 1 and res_n[n][0] == 0
    ]
    print(f"newly-broken by narrow band: {len(victims)}")
    print("narrow-pass signature of victims (ok qcov sim score/base len):")
    for n in victims[:40]:
        ok, qcov, sim, spb, ln = res_n[n]
        print(f"  {n[:40]:42s} qcov={qcov:.3f} sim={sim:5.1f} spb={spb:6.2f} len={ln}")
    vq = np.array([res_n[n][1] for n in victims])
    vs = np.array([res_n[n][2] for n in victims])
    vb = np.array([res_n[n][3] for n in victims])
    vl = np.array([res_n[n][4] for n in victims])
    if len(victims):
        print(f"victim len: med {np.median(vl):.0f} min {vl.min()} max {vl.max()}")
        print(f"victim qcov: med {np.median(vq):.3f} p95 {np.percentile(vq,95):.3f}")
        print(f"victim sim:  med {np.median(vs):.1f} p95 {np.percentile(vs,95):.1f}")
        print(f"victim spb:  med {np.median(vb):.2f} p5 {np.percentile(vb,5):.2f}")
    # how many normal (correct-in-both) reads does each trigger flag?
    normal = [n for n in res_d if res_d[n][0] == 1 and res_n[n][0] == 1]
    for thr_cov, thr_sim in ((0.90, 75.0), (0.95, 78.0), (0.97, 80.0)):
        f_v = sum(
            1 for n in victims
            if res_n[n][1] < thr_cov or res_n[n][2] < thr_sim
        )
        f_n = sum(
            1 for n in normal
            if res_n[n][1] < thr_cov or res_n[n][2] < thr_sim
        )
        print(
            f"trigger qcov<{thr_cov} or sim<{thr_sim}: victims {f_v}/{len(victims)}, "
            f"normals flagged {f_n}/{len(normal)} ({f_n/max(len(normal),1)*100:.1f}%)"
        )
    # long-read-only trigger (short buckets were always narrow-band)
    for thr_cov, thr_sim in ((0.95, 78.0), (0.97, 80.0)):
        f_v = sum(
            1 for n in victims
            if res_n[n][4] > 1536 and (res_n[n][1] < thr_cov or res_n[n][2] < thr_sim)
        )
        nlong = [n for n in normal if res_n[n][4] > 1536]
        f_n = sum(
            1 for n in nlong
            if res_n[n][1] < thr_cov or res_n[n][2] < thr_sim
        )
        print(
            f"long-only qcov<{thr_cov} or sim<{thr_sim}: victims {f_v}/{len(victims)}, "
            f"long normals flagged {f_n}/{len(nlong)}"
        )


if __name__ == "__main__":
    main()
