"""Calibrate an adaptive candidate-depth (CD) trigger.

Most reads' best window wins outright: DPing a second candidate costs
~45% of the device pipeline but only matters for reads with a genuine
competitor (repeat placements -> mapQV < 254, or a better second locus).
This script measures, per golden-corpus read:

  nch1, nch2   chain counts of the two admitted DP windows (the pre-DP
               signal an adaptive trigger can use)
  mapqv        final mapQV at CD=2
  c2_used      the emitted best record came from candidate 2
  c2_close     second candidate's DP score within 75% of the best's
               (the mapQV logsumexp only moves when partitions compete)

and sweeps trigger rules for (a) zero misses on mapQV<254 / c2_used reads
and (b) the flag rate (= fraction paying the CD=2 cost).

Run: python scripts/calibrate_cd.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax.numpy as jnp

    from blasr_jax.index.artifacts import load_index
    from blasr_jax.io.batching import batch_reads, read_records
    from blasr_jax.ops.anchors import find_anchors
    from blasr_jax.ops.candidates import anchor_weights, chain_stats, select_candidates
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.mapper import Mapper, _revcomp_rows, unpack_result

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    index = load_index(os.path.join(root, "benchdata/genome.fasta"), k=14)
    reads = read_records(os.path.join(root, "benchdata/reads.fasta"))
    params = MappingParams(
        batch_size=int(os.environ.get("B", "256")),
        max_read_len=3328, n_candidates=4, n_dp_candidates=2,
        anchor_stride=4, max_anchors_per_read=128,
        narrow_band=32, narrow_band_max=3328, best_n=1, emit_moves=False,
    )
    mapper = Mapper(index, params)
    di = mapper.device_index

    rows = []
    for batch in batch_reads(reads, params.batch_size, params.max_read_len):
        B, L = batch.codes.shape
        codes = jnp.asarray(batch.codes)
        lengths = jnp.asarray(batch.lengths)
        rc = _revcomp_rows(codes, lengths)
        reads2 = jnp.concatenate([codes, rc], axis=0)
        lens2 = jnp.concatenate([lengths, lengths], axis=0)
        sa_valid, ctab16, lut_full, lut_valid = di.arrays
        at, aq, anh, avalid = find_anchors(
            reads2, lens2, sa_valid, None, None, lut_full, None, lut_valid,
            ctab16, k=di.k,
            max_hits_per_pos=params.max_anchors_per_position,
            max_anchors_per_read=params.max_anchors_per_read,
            lut_meta=di.lut_meta, anchor_stride=params.anchor_stride,
        )
        CW = params.candidate_win
        aw = anchor_weights(anh, avalid, di.genome_len, CW, params.pval_type)
        cand = select_candidates(
            at, aq, aw, avalid, n_candidates=params.n_candidates,
            win=CW, k=di.k,
        )
        n_chain, chained_any, cmass, _ = chain_stats(
            at, aq, avalid, cand.dstar, cand.valid, k=di.k, win=CW,
        )
        C = params.n_candidates
        to2 = lambda x: np.asarray(x).reshape(2, B, C).transpose(1, 0, 2).reshape(B, 2 * C)
        nch2 = to2(n_chain)
        vld2 = (
            to2(cand.valid)
            & to2(chained_any)
            & (to2(cmass) > params.min_interval)
        )
        key = np.where(vld2, nch2, -1)
        order = np.argsort(-key, axis=1)
        top = np.take_along_axis(key, order, axis=1)

        res = unpack_result(
            mapper.map_batch(batch.codes, batch.lengths), params.dp_candidates
        )
        sc = res.cand_scores
        sv = res.cand_valid & (sc < 0)
        best_cd = np.where(
            sv[:, 0] & (~sv[:, 1] | (sc[:, 0] <= sc[:, 1])), 0,
            np.where(sv[:, 1], 1, -1),
        )
        mq = res.mapqv.reshape(B, params.best_n)[:, 0]
        for b in range(B):
            if batch.indices[b] < 0:
                continue
            s1 = int(sc[b, 0]) if sv[b, 0] else 0
            s2 = int(sc[b, 1]) if sv[b, 1] else 0
            rows.append((
                int(top[b, 0]), max(int(top[b, 1]), 0),
                int(mq[b]), int(best_cd[b]),
                s1, s2,
            ))
    R = np.array(rows)
    nch1, nch2, mq, bcd, s1, s2 = R.T
    needs = (mq < 254) | (bcd == 1)
    print(f"reads: {len(R)}, needing CD=2 (mq<254 or cand2 won): {needs.sum()}")
    for rule, flag in [
        ("nch2>0", nch2 > 0),
        ("nch2>=2", nch2 >= 2),
        ("nch2>=4", nch2 >= 4),
        ("nch2>=nch1/8", nch2 >= np.maximum(nch1 // 8, 1)),
        ("nch2>=nch1/4", nch2 >= np.maximum(nch1 // 4, 1)),
        ("nch2>=nch1/2", nch2 >= np.maximum(nch1 // 2, 1)),
    ]:
        miss = needs & ~flag
        print(f"  rule {rule:>14}: flag rate {flag.mean()*100:5.1f}%  "
              f"missed needing reads {miss.sum()}")


if __name__ == "__main__":
    main()
