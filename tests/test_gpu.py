"""The CUDA banded-DP kernel against the XLA scan, on the card.

Run where there is an NVIDIA GPU:
    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py
Elsewhere every test here skips. Whether a card is present is decided in
the ``gpu`` fixture, never while the module is imported.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from blasr_jax.ops.banded_align import (
    QOFF_SHIFT,
    AlignScores,
    banded_align,
    clamp_knots_to_shared,
    make_qoff,
    make_qoff_knots,
    make_qoff_num,
    qoff_from_knots,
)

pytestmark = pytest.mark.gpu

MATRIX = (
    -5, -2, 6, 6, 0,
    -2, -5, 6, 6, 0,
    6, 6, -5, 6, 0,
    6, 6, 6, -5, 0,
    0, 0, 0, 0, 0,
)


@pytest.fixture
def gpu():
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip(
            "needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu python -m pytest "
            "-m gpu tests/test_gpu.py"
        )


def _problem(rng, I, L, T):
    Q = np.full((I, L), 4, np.uint8)
    Tc = rng.integers(0, 4, (I, T)).astype(np.uint8)
    qlen = rng.integers(L // 2, L + 1, I).astype(np.int32)
    for i in range(I):
        seg = Tc[i, 40 : 40 + qlen[i]].copy()
        mut = rng.random(len(seg)) < 0.1
        seg[mut] = (seg[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        Q[i, : len(seg)] = seg
    return Q, Tc, qlen


def _inputs(mode, I, L, T, W, seed):
    """Device operands for one kernel mode: the shared drift-slope schedule,
    per-item knots, one or two quality streams, or a score matrix."""
    rng = np.random.default_rng(seed)
    Q, Tc, qlen = _problem(rng, I, L, T)
    S = L + T - 1
    diag = (T - L) // 2
    qoff = make_qoff_num(L, T, W, diag, round((1 << QOFF_SHIFT) / 1.94))
    if mode == "knots":
        aq = np.sort(rng.integers(0, L, (I, 8)), axis=1).astype(np.int32)
        at = aq + 40 + rng.integers(-12, 13, (I, 8)).astype(np.int32)
        knots = make_qoff_knots(
            jnp.asarray(aq + at), jnp.asarray(aq - W // 2),
            jnp.ones((I, 8), bool), S, L, W, diag=diag,
            num=1 << (QOFF_SHIFT - 1),
        )
        shared = jnp.asarray(make_qoff(L, T, W, diag))
        qoff = qoff_from_knots(clamp_knots_to_shared(knots, shared, W), S)
    qual = None
    if mode == "qual8":
        qual = jnp.asarray(rng.integers(3, 45, (I, L)).astype(np.uint8))
    elif mode in ("qual16", "matrix"):
        qual = jnp.asarray(
            rng.integers(3, 45, (I, L)).astype(np.uint16)
            | (rng.integers(3, 45, (I, L)).astype(np.uint16) << 8)
        )
    tlo = rng.integers(0, 8, I).astype(np.int32)
    thi = (T - rng.integers(0, 8, I)).astype(np.int32)
    args = (
        jnp.asarray(Q), jnp.asarray(qlen), jnp.asarray(Tc),
        jnp.asarray(tlo), jnp.asarray(thi), qoff, qual,
    )
    return args, AlignScores(matrix=MATRIX if mode == "matrix" else None)


def _assert_equal(ref, got):
    for f in ("score", "best_a", "best_w"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ref, f)), np.asarray(getattr(got, f)), err_msg=f
        )
    assert bool(jnp.array_equal(ref.arrows, got.arrows)), "arrows differ"


@pytest.mark.parametrize("W", [32, 64, 128, 256])
@pytest.mark.parametrize("mode", ["shared", "knots", "qual8", "qual16", "matrix"])
def test_kernel_matches_scan(gpu, mode, W):
    from blasr_jax.ops.banded_gpu import banded_align_gpu

    args, sc = _inputs(mode, I=37, L=W + 96, T=W + 160, W=W, seed=W)
    with jax.default_device(gpu):
        ref = banded_align(*args, scores=sc, with_traceback=True, band_width=W)
        got = banded_align_gpu(*args, scores=sc, band_width=W)
    _assert_equal(ref, got)


def test_kernel_mesh_matches_scan(gpu):
    """The kernel under shard_map over every visible card (one card: a
    one-device mesh) equals the unsharded scan."""
    from blasr_jax.ops.banded_gpu import banded_align_gpu
    from blasr_jax.parallel.mesh import make_mesh

    n = len(jax.devices("gpu"))
    args, sc = _inputs("knots", I=16 * n, L=160, T=224, W=64, seed=5)
    mesh = make_mesh(n)
    ref = banded_align(*args, scores=sc, with_traceback=True, band_width=64)
    got = banded_align_gpu(*args, scores=sc, band_width=64, mesh=mesh)
    _assert_equal(ref, got)


def test_mapping_gpu_equals_cpu(gpu, small_genome, rng):
    """run_mapping on the card (CUDA DP) gives the CPU path's records."""
    from blasr_jax.index.artifacts import build_index_from_arrays
    from blasr_jax.io.batching import Read
    from blasr_jax.io.seqdb import SeqDB
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping

    seqdb = SeqDB(["ref"], np.array([0, len(small_genome)]), ["0" * 32])
    reads = []
    for i in range(48):
        st = int(rng.integers(0, len(small_genome) - 900))
        seg = small_genome[st : st + int(rng.integers(300, 800))]
        seg = seg[rng.random(len(seg)) >= 0.04]
        ins = np.sort(rng.integers(0, len(seg), len(seg) // 12))
        r = np.insert(seg, ins, rng.integers(0, 4, len(ins)).astype(np.uint8))
        reads.append(Read(f"r{i}", r, None, i))
    params = MappingParams(
        max_read_len=1024, batch_size=16, min_match_length=12, emit_moves=True
    )

    def run(device):
        idx = build_index_from_arrays(small_genome, seqdb, k=12)
        with jax.default_device(device):
            recs, _ = run_mapping(idx, reads, params)
        return [
            (r.qname, r.score, r.tstrand, r.tstart, r.tend, r.qstart, r.qend,
             r.mapqv, r.path.n_match, r.path.n_ins, r.path.n_del)
            for r in recs
        ]

    on_gpu = run(gpu)
    assert len(on_gpu) >= 40
    assert on_gpu == run(jax.devices("cpu")[0])
