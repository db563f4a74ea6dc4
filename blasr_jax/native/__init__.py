"""ctypes loader for the native host kernels (C++, see src/blasr_native.cpp).

The shared library is built on demand with g++ (no pybind11 in the image;
plain C ABI + ctypes keeps the binding layer trivial). Every entry point
has a pure-numpy fallback so the framework works without a toolchain; the
native path is the production one (index builds, ingest, CIGAR formatting).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "blasr_native.cpp")
_SO = os.path.join(_DIR, "libblasr_native.so")

_lib = None
_lock = threading.Lock()
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             _SRC, "-o", _SO],
            check=True, capture_output=True, timeout=300,
        )
        return True
    except Exception:
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("BLASR_JAX_NO_NATIVE"):
            return None
        if not os.path.exists(_SO) or (
            os.path.exists(_SRC) and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
        ):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.bn_sais_i64.argtypes = [u8p, ctypes.c_int64, i64p]
        lib.bn_sais_i64.restype = ctypes.c_int
        lib.bn_sais_i32.argtypes = [u8p, ctypes.c_int32, i32p]
        lib.bn_sais_i32.restype = ctypes.c_int
        lib.bn_encode_strip.argtypes = [ctypes.c_char_p, ctypes.c_int64, u8p]
        lib.bn_encode_strip.restype = ctypes.c_int64
        lib.bn_moves_to_cigar.argtypes = [u8p, ctypes.c_int64, u8p, i32p]
        lib.bn_moves_to_cigar.restype = ctypes.c_int64
        lib.bn_unpack_moves.argtypes = [u8p, ctypes.c_int64, u8p]
        lib.bn_unpack_moves.restype = None
        lib.bn_xeq_cigar.argtypes = [
            u8p, ctypes.c_int64, u8p, u8p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.bn_xeq_cigar.restype = ctypes.c_int64
        lib.bn_sam_fields.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            u8p, ctypes.c_int64, u8p, ctypes.c_int64,
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char, ctypes.c_char_p, ctypes.c_int64, i64p,
        ]
        lib.bn_sam_fields.restype = ctypes.c_int64
        lib.bn_global_align.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            u8p, ctypes.POINTER(ctypes.c_int32),
        ]
        lib.bn_global_align.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def sais(codes: np.ndarray) -> np.ndarray | None:
    """Suffix array via native SA-IS; None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = int(len(codes))
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if n < 2**31:
        sa = np.empty(n, np.int32)
        lib.bn_sais_i32(codes, n, sa)
        return sa.astype(np.int64)
    sa = np.empty(n, np.int64)
    lib.bn_sais_i64(codes, n, sa)
    return sa


def encode_strip(data: bytes) -> np.ndarray | None:
    """ASCII sequence bytes -> codes (whitespace skipped); None if no lib."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(len(data), np.uint8)
    m = lib.bn_encode_strip(data, len(data), out)
    return out[:m].copy()


def moves_to_cigar(packed_row: np.ndarray, nops: int):
    """(ops, lens) forward-order run-length CIGAR; None if no lib."""
    lib = _load()
    if lib is None:
        return None
    packed_row = np.ascontiguousarray(packed_row, dtype=np.uint8)
    op_out = np.empty(max(nops, 1), np.uint8)
    len_out = np.empty(max(nops, 1), np.int32)
    n = lib.bn_moves_to_cigar(packed_row, nops, op_out, len_out)
    return op_out[:n], len_out[:n]


def unpack_moves(packed_row: np.ndarray, nops: int) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    packed_row = np.ascontiguousarray(packed_row, dtype=np.uint8)
    out = np.empty(max(nops, 1), np.uint8)
    lib.bn_unpack_moves(packed_row, nops, out)
    return out[:nops]


_EMPTY_U8 = np.zeros(1, np.uint8)
_FIELD_BUFS = threading.local()


def _field_buf(cap: int):
    """Reusable output buffer (per thread): create_string_buffer per record
    measured ~5 us x 2000 records of pure allocation."""
    buf = getattr(_FIELD_BUFS, "buf", None)
    if buf is None or len(buf) < cap:
        buf = ctypes.create_string_buffer(max(cap, 1 << 15))
        _FIELD_BUFS.buf = buf
    return buf


def sam_fields(
    packed_moves: np.ndarray, nops: int, q_start: int, t_start: int,
    fwd_codes: np.ndarray, qual: np.ndarray | None,
    t_aln: np.ndarray, strand: int, clip_mode: int, clip_op: str,
) -> tuple[str, str, str] | None:
    """One native pass producing (cigar, seq, qual) for a SAM record —
    consumes the device walk's packed move string directly (no ops
    unpacking), applies orientation + clipping (SAMPrinter.h:59-260 roles).
    clip_mode: 0 none, 1 soft/subread, 2 hard. None if lib unavailable."""
    lib = _load()
    if lib is None:
        return None
    packed_moves = np.ascontiguousarray(packed_moves, dtype=np.uint8)
    fwd_codes = np.ascontiguousarray(fwd_codes, dtype=np.uint8)
    has_q = 0
    qarr = _EMPTY_U8
    if qual is not None:
        qarr = np.ascontiguousarray(qual, dtype=np.uint8)
        has_q = 1
    t_aln = np.ascontiguousarray(t_aln, dtype=np.uint8)
    n = len(fwd_codes)
    cap = 12 * (nops + 2) + 2 * n + 64
    buf = _field_buf(cap)
    lens = np.zeros(3, np.int64)
    total = lib.bn_sam_fields(
        packed_moves, nops, q_start, t_start, fwd_codes, n, qarr, has_q,
        t_aln, len(t_aln), strand, clip_mode, clip_op.encode()[:1] or b"S",
        buf, cap, lens,
    )
    if total < 0:
        return None
    # slice the ctypes array directly (buf.raw would copy the WHOLE
    # reusable buffer per record)
    c0 = int(lens[0])
    s0 = c0 + 1 + int(lens[1])
    return (
        buf[:c0].decode(),
        buf[c0 + 1 : s0].decode(),
        buf[s0 + 1 : s0 + 1 + int(lens[2])].decode(),
    )


def xeq_cigar(
    ops: np.ndarray, q_aln: np.ndarray, t_aln: np.ndarray,
    q_start: int, t_start: int, pre_clip: int, post_clip: int, clip_op: str,
) -> str | None:
    """Full SAM CIGAR string with M split into =/X (one C pass); None if
    the lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    ops = np.ascontiguousarray(ops, dtype=np.uint8)
    q_aln = np.ascontiguousarray(q_aln, dtype=np.uint8)
    t_aln = np.ascontiguousarray(t_aln, dtype=np.uint8)
    # worst case: every op alternates -> len(str(n)) + 1 per op, plus clips
    cap = 12 * (len(ops) + 2) + 48
    buf = ctypes.create_string_buffer(cap)
    n = lib.bn_xeq_cigar(
        ops, len(ops), q_aln, t_aln, q_start, t_start,
        pre_clip, post_clip, clip_op.encode()[:1] or b"S", buf, cap,
    )
    if n < 0:
        return None
    return buf.raw[:n].decode()


def global_align(
    q: np.ndarray, t: np.ndarray,
    match: int, mismatch: int, nscore: int, ins: int, dele: int,
    max_cells: int = 1 << 26,
):
    """Dense global DP with traceback (host gap filler). Returns
    (ops uint8 START->END, score) or None if the lib is unavailable or the
    matrix exceeds max_cells."""
    lib = _load()
    if lib is None:
        return None
    q = np.ascontiguousarray(q, dtype=np.uint8)
    t = np.ascontiguousarray(t, dtype=np.uint8)
    ops = np.empty(len(q) + len(t) + 1, np.uint8)
    score = ctypes.c_int32(0)
    n = lib.bn_global_align(
        q, len(q), t, len(t), match, mismatch, nscore, ins, dele,
        max_cells, ops, ctypes.byref(score),
    )
    if n < 0:
        return None
    return ops[:n].copy(), int(score.value)
