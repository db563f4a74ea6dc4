"""Multi-chip scaling via jax.sharding (role of reference §2.9 parallelism).

The reference's single parallel strategy is data parallelism over reads
(N pthreads + reader/writer semaphores, Blasr.cpp:4794-4849). The device
equivalent is a 1-D ``dp`` device mesh: read batches are sharded on the
batch axis, the genome index is replicated (small genomes; contig-sharding
with all-gather candidate merge is the hg19-scale path), and the whole
jitted map step runs SPMD — XLA inserts the collectives (e.g. the psum for
the batch-wide mapped-read count).

No NCCL/MPI analogue is needed: host->device read distribution happens via
``jax.device_put`` with NamedSharding; outputs come back already
batch-ordered.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from blasr_jax.pipeline.mapper import (
    DeviceIndex,
    MapBatchResult,
    _map_batch_impl,
    dp_impl_for,
)
from blasr_jax.params import MappingParams


def make_mesh(n_devices: int | None = None, axis_name: str = "dp") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def shard_batch(mesh: Mesh, codes: np.ndarray, lengths: np.ndarray, axis: str = "dp"):
    """Place a padded read batch sharded over the mesh's dp axis."""
    dp2 = NamedSharding(mesh, P(axis, None))
    dp1 = NamedSharding(mesh, P(axis))
    return jax.device_put(codes, dp2), jax.device_put(lengths, dp1)


def replicate_index(mesh: Mesh, di: DeviceIndex) -> DeviceIndex:
    rep = NamedSharding(mesh, P())
    return DeviceIndex(
        genome_pad=jax.device_put(di.genome_pad, rep),
        arrays=tuple(
            jax.device_put(a, rep) if a is not None else None
            for a in di.arrays
        ),
        starts=jax.device_put(di.starts, rep),
        pad=di.pad,
        k=di.k,
        genome_len=di.genome_len,
        kind=di.kind,
        fm_n=di.fm_n,
        lut_meta=di.lut_meta,
    )


def sharded_map_batch(
    mesh: Mesh,
    di: DeviceIndex,
    params: MappingParams,
    codes: np.ndarray,
    lengths: np.ndarray,
) -> MapBatchResult:
    """Run the full mapping step SPMD over the mesh (batch axis sharded)."""
    if codes.shape[0] % mesh.devices.size != 0:
        raise ValueError(
            f"batch size {codes.shape[0]} not divisible by {mesh.devices.size} devices"
        )
    c, l = shard_batch(mesh, codes, lengths)
    dri = replicate_index(mesh, di)
    return _map_batch_impl(
        c, l,
        dri.genome_pad, dri.arrays, dri.starts,
        params=params, pad=di.pad, k=di.k, genome_len=di.genome_len,
        dp=dp_impl_for(mesh.devices.flat[0].platform),
        index_kind=di.kind, fm_n=di.fm_n, lut_meta=di.lut_meta, mesh=mesh,
    )
