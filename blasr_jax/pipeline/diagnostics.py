"""Diagnostic side-channel writers for the CLI (-fullMetrics, -clusters,
-lcpBounds).

Roles:
  * write_full_metrics — reference MappingMetrics::PrintFullList
    (datastructures/mapping/MappingMetrics.h:307; opened Blasr.cpp:4224,
    printed :4872). The reference emits one row per read of per-stage CPU
    clocks. The device pipeline maps whole batches in ONE fused device
    program, so per-read stage clocks do not physically exist; rows carry
    the real per-read counters (length, mapped bases, alignments, best
    score, mapQV) and the run's stage seconds amortized per read, with the
    amortization stated in the header.
  * write_clusters — reference -clusters (Blasr.cpp:4536). The reference
    fork writes the header line and no rows (no surviving row-emission
    code in Blasr.cpp); rows here are a superset carrying per-alignment
    cluster stats in the header's column order.
  * write_lcp_bounds — reference -lcpBounds
    (MapBySuffixArray.h:77-85): per MapReadToGenome call, one line of
    space-separated SA match-interval widths, one value per seed position.
    Emitted per read for forward then reverse-complement strands, matching
    the reference's fwd-then-rc call order (Blasr.cpp:2278-2305).
"""

from __future__ import annotations

from typing import IO, Sequence

import numpy as np

from blasr_jax.core.encode import pack_kmers


def write_full_metrics(
    out: IO[str], reads, records, unmapped, run_metrics
) -> None:
    per_read = {}
    for rec in records:
        e = per_read.setdefault(
            rec.read_index, {"n": 0, "best": 0, "mapqv": 0, "bases": 0}
        )
        e["n"] += 1
        if rec.score < e["best"]:
            e["best"] = rec.score
            e["mapqv"] = rec.mapqv
        e["bases"] = max(e["bases"], rec.qend - rec.qstart)
    n = max(len(reads), 1)
    amort = {
        "DispatchMsPerRead": 1000.0 * run_metrics.dispatch_seconds / n,
        "FinalizeMsPerRead": 1000.0 * run_metrics.finalize_seconds / n,
        "TotalMsPerRead": 1000.0 * run_metrics.wall_seconds / n,
    }
    out.write(
        "# per-stage clocks are per-read amortized (batched device "
        "mapping): "
        + " ".join(f"{k}={v:.4f}" for k, v in amort.items())
        + "\n"
    )
    out.write(
        "Read Length Mapped NAlignments BestScore MapQV MappedBases Cells\n"
    )
    for i, rd in enumerate(reads):
        e = per_read.get(i)
        cells = (
            run_metrics.total_dp_cells // n if run_metrics.total_dp_cells else 0
        )
        if e is None:
            out.write(f"{rd.name} {len(rd.codes)} 0 0 0 0 0 {cells}\n")
        else:
            out.write(
                f"{rd.name} {len(rd.codes)} 1 {e['n']} {e['best']} "
                f"{e['mapqv']} {e['bases']} {cells}\n"
            )


def write_clusters(out: IO[str], reads, records) -> None:
    out.write(
        "total_size p_value n_anchors read_length align_score "
        "read_accuracy anchor_probability min_exp_anchors seq_length\n"
    )
    for rec in records:
        qlen = rec.qlength
        span = rec.qend - rec.qstart
        acc = rec.pct_similarity / 100.0
        # total_size/n_anchors: anchor bases inside the winning cluster.
        # nhits_considered carries the candidate's member-anchor count out
        # of the device program when available; 0 otherwise.
        n_anchors = int(getattr(rec, "nhits_considered", 0) or 0)
        out.write(
            f"{span} {rec.score} {n_anchors} {qlen} {rec.score} "
            f"{acc:.4f} 0 0 {qlen}\n"
        )


def write_lcp_bounds(out: IO[str], reads: Sequence, index) -> None:
    sa_kmers = np.asarray(index.sa_kmers)
    k = index.k
    for rd in reads:
        codes = np.asarray(rd.codes)
        for strand in (0, 1):
            c = (
                codes
                if strand == 0
                else np.where(codes < 4, 3 - codes, codes)[::-1]
            )
            if len(c) < k:
                out.write("\n")
                continue
            keys, valid = pack_kmers(c, k)
            keys = keys[: len(c) - k + 1]
            valid = valid[: len(c) - k + 1]
            lo = np.searchsorted(sa_kmers, keys, side="left")
            hi = np.searchsorted(sa_kmers, keys, side="right")
            widths = np.where(valid, hi - lo, 0)
            out.write(" ".join(str(int(w)) for w in widths) + "\n")
