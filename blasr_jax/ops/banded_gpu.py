"""The banded DP as a CUDA kernel for the GPU (cuda/banded_dp.cu).

Same inputs, outputs and bit-exact results as ``banded_align.banded_align``
(the XLA scan, which stays the reference): scores, end cells and the
(S, I, W) uint16 arrow words that ``traceback_device.walk_arrows_device``
walks. The kernel runs the whole anti-diagonal loop inside one launch, one
warp per item, where XLA's scan pays a loop iteration of small kernels per
anti-diagonal.

It covers the modes the mapper uses: the shared band schedule (S,) and the
per-item guided schedule (S, I); no, one (uint8) or two packed (uint16)
quality streams; the static ``-scoreMatrix``; W = 32, 64, 128 or 256
(``kernel_handles``). It always writes arrows. Other band widths and the
score-only ``global_q`` mode stay on ``banded_align``.

The library is built from the source in this package with ``nvcc`` at first
use, into ``cuda/build/`` (git-ignored), or ahead of time with
``python -m blasr_jax.ops.banded_gpu``. There is no interpret mode: the
CPU tests cover the operand rules below, and ``tests/test_gpu.py`` compares
the kernel with ``banded_align`` on the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from blasr_jax.ops.banded_align import AlignScores, BandedResult

TARGET = "blasr_banded_dp"
KERNEL_WIDTHS = (32, 64, 128, 256)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda", "banded_dp.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_SRC), "build")
_lock = threading.Lock()
_registered = False


def kernel_handles(band_width: int) -> bool:
    """Whether the kernel covers this band width (one to eight cells per
    lane of a warp); the mapper sends any other width to banded_align."""
    return band_width in KERNEL_WIDTHS


def library_path() -> str:
    """Where the library built from the current source lives (the name
    carries the source's hash, so an edited source never loads stale code)."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libbanded_dp_{digest}.so")


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> str:
    """Compile the kernel library if it is not built yet; returns its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.part"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", tmp, _SRC,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent builder sees all or nothing
    return path


def _register() -> None:
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.CDLL(build())
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.BandedDp), platform="CUDA"
        )
        _registered = True


def kernel_operands(qoff, qual, scores: AlignScores):
    """The kernel's operand rules, shared by every call.

    - the shared schedule (S,) travels as (S, 1); a per-item (S, I) as is;
    - qualities travel as uint16 with ``qmode`` 1 (one uint8 stream, widened)
      or 2 (two packed streams: low byte mismatches, high byte
      insertions); without qualities a (1, 1) placeholder and qmode 0;
    - the substitution matrix travels as 25 int32 attributes, zeros and
      ``use_matrix`` 0 when the match/mismatch/N scores apply.

    Returns (qoff2, qual16, attrs).
    """
    qoff2 = qoff[:, None] if qoff.ndim == 1 else qoff
    if qual is None:
        qmode, qual16 = 0, jnp.zeros((1, 1), jnp.uint16)
    elif qual.dtype == jnp.uint16:
        qmode, qual16 = 2, qual
    elif qual.dtype == jnp.uint8:
        qmode, qual16 = 1, qual.astype(jnp.uint16)
    else:
        raise TypeError(f"quality stream must be uint8 or uint16, not {qual.dtype}")
    mat = scores.matrix
    attrs = dict(
        match=np.int32(scores.match),
        mismatch=np.int32(scores.mismatch),
        n_score=np.int32(scores.n_score),
        insertion=np.int32(scores.insertion),
        deletion=np.int32(scores.deletion),
        affine_open=np.int32(scores.affine_open),
        affine_extend=np.int32(scores.affine_extend),
        qmode=np.int32(qmode),
        use_matrix=np.int32(mat is not None),
        matrix=np.asarray(mat if mat is not None else [0] * 25, np.int32),
    )
    return qoff2, qual16, attrs


def shard_specs(axis: str, per_item: bool, qmode: int):
    """shard_map specs splitting the items over a 1-D mesh axis: every
    per-item operand splits on its item dimension; the shared schedule and
    the quality placeholder are replicated."""
    item = P(axis)
    rows = P(axis, None)
    in_specs = (
        rows, item, rows, item, item,
        P(None, axis) if per_item else P(None, None),
        rows if qmode else P(None, None),
    )
    out_specs = (item, item, item, P(None, axis, None))
    return in_specs, out_specs


def _call(query, qlen, target, tlo, thi, qoff2, qual16, *, W, attrs):
    I, L = query.shape
    S = qoff2.shape[0]
    out = (
        jax.ShapeDtypeStruct((I,), jnp.int32),
        jax.ShapeDtypeStruct((I,), jnp.int32),
        jax.ShapeDtypeStruct((I,), jnp.int32),
        jax.ShapeDtypeStruct((S, I, W), jnp.uint16),
    )
    return jax.ffi.ffi_call(TARGET, out)(
        query, qlen.astype(jnp.int32), target, tlo.astype(jnp.int32),
        thi.astype(jnp.int32), qoff2.astype(jnp.int32), qual16, **attrs
    )


@functools.partial(jax.jit, static_argnames=("scores", "band_width", "mesh"))
def banded_align_gpu(
    query: jax.Array,    # (I, L) uint8 codes 0..4
    qlen: jax.Array,     # (I,) int32
    target: jax.Array,   # (I, T) uint8 codes 0..5
    tlo: jax.Array,      # (I,) int32
    thi: jax.Array,      # (I,) int32
    qoff: jax.Array,     # (S,) shared or (S, I) per-item band schedule
    qual: jax.Array | None = None,  # (I, L) uint8 or packed uint16
    *,
    scores: AlignScores = AlignScores(),
    band_width: int = 128,
    mesh=None,           # 1-D mesh whose axis splits the items
) -> BandedResult:
    """banded_align(..., with_traceback=True) on the GPU kernel."""
    if not kernel_handles(band_width):
        raise ValueError(f"band width {band_width} not in {KERNEL_WIDTHS}")
    I, L = query.shape
    S = qoff.shape[0]
    if S != L + target.shape[1] - 1:
        raise ValueError("qoff must have L + T - 1 steps")
    _register()
    qoff2, qual16, attrs = kernel_operands(qoff, qual, scores)
    call = functools.partial(_call, W=band_width, attrs=attrs)
    if mesh is not None:
        in_specs, out_specs = shard_specs(
            mesh.axis_names[0], qoff2.shape[1] > 1, int(attrs["qmode"])
        )
        call = jax.shard_map(
            call, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )
    score, best_a, best_w, arrows = call(
        query, qlen, target, tlo, thi, qoff2, qual16
    )
    return BandedResult(score, best_a, best_w, arrows)


if __name__ == "__main__":
    print(build())
