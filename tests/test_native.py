"""Native C++ host kernels vs Python oracles."""

import numpy as np
import pytest

from blasr_jax import native
from blasr_jax.index.suffix_array import build_suffix_array_naive


@pytest.fixture(scope="module")
def rngn():
    return np.random.default_rng(7)


def test_native_available():
    assert native.available(), "native library must build in this image"


def test_sais_matches_naive(rngn):
    for n in (1, 2, 5, 33, 200, 999):
        c = rngn.integers(0, 5, n).astype(np.uint8)
        sa = native.sais(c)
        np.testing.assert_array_equal(sa, build_suffix_array_naive(c))


def test_sais_repetitive():
    for s in (b"abracadabra", b"aaaaaaaaaa", b"banana", b"mississippi" * 3):
        c = np.frombuffer(s, np.uint8).copy()
        np.testing.assert_array_equal(native.sais(c), build_suffix_array_naive(c))


def test_encode_strip():
    out = native.encode_strip(b"AC\nGT acgt\tNx\r\n")
    np.testing.assert_array_equal(out, [0, 1, 2, 3, 0, 1, 2, 3, 4, 4])


def test_moves_to_cigar_and_unpack(rngn):
    from blasr_jax.pipeline.traceback import AlignmentPath

    ops_fwd = rngn.integers(1, 4, 37).astype(np.uint8)
    # pack in END->START order, 2 bits per op
    rev = ops_fwd[::-1]
    packed = np.zeros((len(rev) + 3) // 4, np.uint8)
    for j, op in enumerate(rev):
        packed[j >> 2] |= op << (2 * (j & 3))
    np.testing.assert_array_equal(native.unpack_moves(packed, len(rev)), ops_fwd)
    co, cl = native.moves_to_cigar(packed, len(rev))
    # oracle RLE via AlignmentPath
    p = AlignmentPath(0, 0, 0, 0, ops_fwd, -1)
    runs = p.cigar_runs()
    chars = {1: "M", 2: "I", 3: "D"}
    assert [(chars[int(o)], int(l)) for o, l in zip(co, cl)] == runs


def test_xeq_cigar_matches_numpy(rngn):
    """Native one-pass =/X CIGAR equals the numpy _xeq_runs construction
    over random op strings, all clip modes."""
    from blasr_jax.output.sam_writer import _xeq_runs

    if not native.available():
        import pytest

        pytest.skip("native lib unavailable")
    for trial in range(20):
        n = int(rngn.integers(1, 300))
        ops = rngn.integers(1, 4, n).astype(np.uint8)
        nq = int((ops != 3).sum())
        nt = int((ops != 2).sum())
        q0, t0 = int(rngn.integers(0, 5)), int(rngn.integers(0, 5))
        q = rngn.integers(0, 4, nq + q0 + 4).astype(np.uint8)
        t = rngn.integers(0, 4, nt + t0 + 4).astype(np.uint8)
        pre, post = int(rngn.integers(0, 9)), int(rngn.integers(0, 9))
        for clip_op in ("S", "H"):
            runs = _xeq_runs(ops, q, t, q0, t0)
            expect = "".join(
                ([f"{pre}{clip_op}"] if pre else [])
                + [f"{ln}{op}" for ln, op in runs]
                + ([f"{post}{clip_op}"] if post else [])
            )
            got = native.xeq_cigar(ops, q, t, q0, t0, pre, post, clip_op)
            assert got == expect, (trial, clip_op)


def test_sam_fields_matches_python_reference():
    """native.sam_fields (one C pass from the packed walk output) must be
    byte-identical to the python cigar/seq/qual assembly across strands,
    clip modes, and qual presence."""
    import numpy as np

    from blasr_jax import native
    from blasr_jax.core.encode import codes_to_seq, revcomp_codes
    from blasr_jax.output.sam_writer import _xeq_runs

    if not native.available():
        import pytest

        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(0)
    for trial in range(60):
        n = int(rng.integers(30, 200))
        read = rng.integers(0, 4, n).astype(np.uint8)
        q_start = int(rng.integers(0, 10))
        nops = int(rng.integers(5, n - q_start))
        ops = rng.choice([1, 1, 1, 2, 3], nops).astype(np.uint8)
        nq = int((ops != 3).sum())
        if q_start + nq > n:
            continue
        rev = ops[::-1]
        packed = np.zeros((nops + 3) // 4 + 1, np.uint8)
        for j, op in enumerate(rev):
            packed[j >> 2] |= op << (2 * (j & 3))
        t_start = int(rng.integers(0, 5))
        nt = int((ops != 2).sum())
        t_aln = rng.integers(0, 4, t_start + nt + 4).astype(np.uint8)
        strand = int(rng.integers(0, 2))
        qual = (
            rng.integers(0, 60, n).astype(np.uint8)
            if rng.random() < 0.5 else None
        )
        for clip_mode, clipping in ((0, "none"), (1, "soft"), (2, "hard")):
            clip_op = "S" if clipping == "soft" else "H"
            got = native.sam_fields(
                packed, nops, q_start, t_start, read, qual, t_aln, strand,
                clip_mode, clip_op,
            )
            codes = read if strand == 0 else revcomp_codes(read)
            q = qual if qual is None or strand == 0 else qual[::-1]
            runs = _xeq_runs(ops, codes, t_aln, q_start, t_start)
            parts = []
            pre, post = q_start, n - (q_start + nq)
            if clip_mode and pre:
                parts.append(f"{pre}{clip_op}")
            parts += [f"{ln}{op}" for ln, op in runs]
            if clip_mode and post:
                parts.append(f"{post}{clip_op}")
            cigar = "".join(parts)
            c2 = codes if clip_mode != 2 else codes[q_start : q_start + nq]
            q2 = None if q is None else (
                q if clip_mode != 2 else q[q_start : q_start + nq]
            )
            seq = codes_to_seq(c2)
            qs = (
                "*" if q2 is None
                else (np.asarray(q2) + 33).astype(np.uint8).tobytes().decode()
            )
            assert got == (cigar, seq, qs), (trial, clipping, strand)
