"""Diagnostic dumps (role of the reference's -anchors / -clusters side
channels, Blasr.cpp:2309-2333 anchor dump and :4536 cluster stats)."""

from __future__ import annotations

from typing import IO, Sequence

import jax.numpy as jnp
import numpy as np

from blasr_jax.index.artifacts import GenomeIndex
from blasr_jax.io.batching import Read, batch_reads
from blasr_jax.ops.anchors import find_anchors
from blasr_jax.params import MappingParams
from blasr_jax.pipeline.mapper import _revcomp_rows


def dump_anchors(
    index: GenomeIndex,
    reads: Sequence[Read],
    params: MappingParams,
    out: IO[str],
    fm=None,
) -> None:
    """Write every anchor as 'read_name strand qpos tpos nhits'.

    Dispatches the same engine the mapper would use: FM backward search
    when an FM bundle is given (e.g. -bwt runs whose GenomeIndex carries
    no SA), wide keys for k > 15, else the narrow SA search."""
    from blasr_jax.ops.fm_search import find_anchors_fm
    from blasr_jax.ops.anchors import find_anchors_wide

    k = index.k
    if fm is None:
        sa32 = index.sa.astype(np.int32)
        sa_m = jnp.asarray(np.where(index.pos_ok[sa32], sa32, np.int32(-1)))
        lut, shift, max_steps = index.lut()
        lutd = jnp.asarray(lut)
        if 2 * k > 31:
            full = index.sa_kmers.astype(np.int64)
            lo_bits = 2 * k - 30
            kh = jnp.asarray((full >> lo_bits).astype(np.int32))
            kl = jnp.asarray((full & ((1 << lo_bits) - 1)).astype(np.int32))
        else:
            sk = jnp.asarray(index.sa_kmers)
    else:
        fm_arrays = tuple(
            jnp.asarray(a) for a in (
                fm.bwt_rows, fm.occ_bins, fm.C.astype(np.int32),
                fm.ssa_mask, fm.ssa_base, fm.ssa_vals.astype(np.int32),
            )
        )
        pk = jnp.asarray(index.pos_ok)
    for batch in batch_reads(reads, params.batch_size, params.max_read_len):
        codes = jnp.asarray(batch.codes)
        lengths = jnp.asarray(batch.lengths)
        rc = _revcomp_rows(codes, lengths)
        B = batch.codes.shape[0]
        for strand, strand_codes in ((0, codes), (1, rc)):
            if fm is not None:
                t, q, nh, valid = find_anchors_fm(
                    strand_codes, lengths, *fm_arrays, pk,
                    k=k, n=fm.n,
                    max_hits_per_pos=params.max_anchors_per_position,
                    max_anchors_per_read=params.max_anchors_per_read,
                )
            elif 2 * k > 31:
                t, q, nh, valid = find_anchors_wide(
                    strand_codes, lengths, sa_m, kh, kl, lutd,
                    k=k, lut_meta=(shift, max_steps),
                    max_hits_per_pos=params.max_anchors_per_position,
                    max_anchors_per_read=params.max_anchors_per_read,
                )
            else:
                t, q, nh, valid = find_anchors(
                    strand_codes, lengths, sa_m, sk, None, lutd,
                    k=k, lut_meta=(shift, max_steps),
                    max_hits_per_pos=params.max_anchors_per_position,
                    max_anchors_per_read=params.max_anchors_per_read,
                )
            t = np.asarray(t); q = np.asarray(q)
            nh = np.asarray(nh); valid = np.asarray(valid)
            for b in range(B):
                if batch.indices[b] < 0:
                    continue
                name = batch.names[b]
                order = np.argsort(q[b])
                for i in order:
                    if valid[b][i]:
                        out.write(
                            f"{name} {strand} {q[b][i]} {t[b][i]} {nh[b][i]}\n"
                        )
