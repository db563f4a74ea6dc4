"""CPU tests of the device-path rules: which DP each platform runs, the
CUDA kernel wrapper's operand, routing and sharding rules (with the kernel
itself replaced by the XLA scan, since a CUDA kernel cannot run here), the
compile-cache location, and chip_smoke.py refusing to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import blasr_jax
from blasr_jax.ops import banded_gpu
from blasr_jax.ops.banded_align import AlignScores, banded_align, make_qoff
from blasr_jax.pipeline.mapper import dp_impl_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scan_as_kernel(query, qlen, target, tlo, thi, qoff2, qual16, *, W, attrs):
    """Stands in for the FFI call: decodes the kernel operands back into
    banded_align's arguments, so a test sees exactly what the kernel would."""
    qmode = int(attrs["qmode"])
    qual = {0: None, 1: qual16.astype(jnp.uint8), 2: qual16}[qmode]
    mat = tuple(int(v) for v in attrs["matrix"]) if attrs["use_matrix"] else None
    sc = AlignScores(
        match=int(attrs["match"]), mismatch=int(attrs["mismatch"]),
        n_score=int(attrs["n_score"]), insertion=int(attrs["insertion"]),
        deletion=int(attrs["deletion"]), affine_open=int(attrs["affine_open"]),
        affine_extend=int(attrs["affine_extend"]), matrix=mat,
    )
    qoff = qoff2[:, 0] if qoff2.shape[1] == 1 else qoff2
    r = banded_align(query, qlen, target, tlo, thi, qoff, qual, scores=sc,
                     with_traceback=True, band_width=W)
    return r.score, r.best_a, r.best_w, r.arrows


@pytest.fixture
def fake_kernel(monkeypatch):
    monkeypatch.setattr(banded_gpu, "_call", _scan_as_kernel)
    monkeypatch.setattr(banded_gpu, "_register", lambda: None)


def test_dp_impl_per_platform():
    assert dp_impl_for("cpu") == "xla"
    assert dp_impl_for("gpu") == "cuda"
    for other in ("rocm", "METAL", "neuron"):
        with pytest.raises(RuntimeError, match="no device path"):
            dp_impl_for(other)


def test_kernel_routing_rule():
    assert [w for w in (16, 32, 64, 96, 128, 256, 384, 512)
            if banded_gpu.kernel_handles(w)] == [32, 64, 128, 256]
    with pytest.raises(ValueError):
        banded_gpu.banded_align_gpu(
            jnp.zeros((2, 8), jnp.uint8), jnp.zeros(2, jnp.int32),
            jnp.zeros((2, 8), jnp.uint8), jnp.zeros(2, jnp.int32),
            jnp.zeros(2, jnp.int32), jnp.zeros(15, jnp.int32), band_width=512,
        )


def test_kernel_operand_rules():
    S, I, L = 11, 3, 4
    qoff = jnp.arange(S, dtype=jnp.int32)
    q2, qu, attrs = banded_gpu.kernel_operands(qoff, None, AlignScores())
    assert q2.shape == (S, 1) and qu.shape == (1, 1) and qu.dtype == jnp.uint16
    assert attrs["qmode"] == 0 and attrs["use_matrix"] == 0
    assert attrs["matrix"].shape == (25,) and attrs["matrix"].dtype == np.int32
    per_item = jnp.zeros((S, I), jnp.int32)
    q8 = jnp.full((I, L), 200, jnp.uint8)
    q2, qu, attrs = banded_gpu.kernel_operands(per_item, q8, AlignScores())
    assert q2.shape == (S, I) and attrs["qmode"] == 1
    assert qu.dtype == jnp.uint16 and int(qu[0, 0]) == 200
    q16 = jnp.full((I, L), 30 | (5 << 8), jnp.uint16)
    mat = tuple(range(25))
    _, qu, attrs = banded_gpu.kernel_operands(qoff, q16, AlignScores(matrix=mat))
    assert attrs["qmode"] == 2 and qu is q16
    assert attrs["use_matrix"] == 1 and attrs["matrix"].tolist() == list(mat)
    with pytest.raises(TypeError):
        banded_gpu.kernel_operands(qoff, q8.astype(jnp.int32), AlignScores())


@pytest.mark.parametrize("per_item,qual", [(False, None), (True, "u16"), (False, "u8")])
def test_kernel_shards_items_over_mesh(fake_kernel, per_item, qual):
    """Under a 4-device mesh every per-item operand splits on its item
    axis and the result equals the unsharded scan."""
    from blasr_jax.parallel.mesh import make_mesh

    rng = np.random.default_rng(4)
    I, L, T, W = 8, 40, 72, 32
    Q = rng.integers(0, 4, (I, L)).astype(np.uint8)
    Tc = rng.integers(0, 4, (I, T)).astype(np.uint8)
    Tc[:, 10 : 10 + L] = Q
    qoff = jnp.asarray(make_qoff(L, T, W, (T - L) // 2))
    if per_item:
        qoff = jnp.tile(qoff[:, None], (1, I))
    qu = None
    if qual == "u8":
        qu = jnp.asarray(rng.integers(3, 45, (I, L)).astype(np.uint8))
    elif qual == "u16":
        qu = jnp.asarray(rng.integers(3, 45, (I, L)).astype(np.uint16) * 257)
    args = (jnp.asarray(Q), jnp.full(I, L, jnp.int32), jnp.asarray(Tc),
            jnp.zeros(I, jnp.int32), jnp.full(I, T, jnp.int32), qoff, qu)
    ref = banded_align(*args, with_traceback=True, band_width=W)
    got = banded_gpu.banded_align_gpu(*args, band_width=W, mesh=make_mesh(4))
    for f in ref._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(ref, f)), np.asarray(getattr(got, f)), err_msg=f
        )


@pytest.mark.parametrize("mesh_devices", [None, 4])
def test_mapper_gpu_path_equals_xla_path(fake_kernel, mesh_devices):
    """The mapper's GPU path (dp='cuda') hands the kernel the same DP the
    XLA path computes: with the kernel replaced by the scan, records are
    identical, on one device and sharded over a mesh."""
    import __graft_entry__ as ge
    from blasr_jax.parallel.mesh import make_mesh, replicate_index, shard_batch
    from blasr_jax.pipeline.mapper import _map_batch_impl, make_device_index

    index, params, codes, lengths = ge._tiny_problem(n_reads=8, seed=3)
    di = make_device_index(index, params)
    mesh = None if mesh_devices is None else make_mesh(mesh_devices)
    c, l = codes, lengths
    if mesh is not None:
        c, l = shard_batch(mesh, codes, lengths)
        di = replicate_index(mesh, di)
    out = {}
    for dp in ("xla", "cuda"):
        out[dp] = _map_batch_impl(
            c, l, di.genome_pad, di.arrays, di.starts,
            params=params, pad=di.pad, k=di.k, genome_len=di.genome_len,
            dp=dp, index_kind=di.kind, fm_n=di.fm_n, lut_meta=di.lut_meta,
            mesh=mesh,
        )
    for f in out["xla"]._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(out["xla"], f)), np.asarray(getattr(out["cuda"], f))
        )
    assert int(np.asarray(out["xla"].sel_ints)[3].sum()) >= 6  # reads placed


def test_compile_cache_dir(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    assert blasr_jax.compilation_cache_dir() == "/somewhere/else"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    d = blasr_jax.compilation_cache_dir()
    assert d == os.path.join(REPO, ".jax_cache") == blasr_jax.compilation_cache_dir()
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """No accelerator (or no repo beside the script): non-zero exit and no
    result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    proc = subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_band_width_rule_is_whole_warps():
    from blasr_jax.params import MappingParams

    for ok in (32, 64, 96, 128, 256, 640):
        MappingParams(band_width=ok).validate()
    for bad in (0, 16, 100, 130):
        with pytest.raises(ValueError, match="multiple of 32"):
            MappingParams(band_width=bad).validate()
