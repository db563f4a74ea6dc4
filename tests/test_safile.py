"""Reference-format .sa file interop (SuffixArray.h:505 binary layout)."""

import os
import subprocess

import numpy as np
import pytest

from blasr_jax.index.safile import (
    read_sa_file,
    read_sa_lookup,
    reference_order_sa,
    write_sa_file,
)

REF_SAWRITER = "/tmp/refbuild/alignment/bin/sawritermc"


def _random_fasta(path, n, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    seq = "".join("ACGT"[c] for c in codes)
    with open(path, "w") as f:
        f.write(">chr1\n")
        for i in range(0, len(seq), 60):
            f.write(seq[i : i + 60] + "\n")
    return codes


def test_sa_file_roundtrip(tmp_path):
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 5000).astype(np.uint8)
    rows = reference_order_sa(genome)
    assert rows[-1] == len(genome)  # empty suffix sorts last
    p = str(tmp_path / "g.sa")
    write_sa_file(p, rows, genome=genome, lookup_prefix_len=4)
    back = read_sa_file(p)
    np.testing.assert_array_equal(back, rows)
    sa = read_sa_file(p, genome_len=len(genome))  # sentinel stripped
    lut = read_sa_lookup(p)
    assert lut is not None
    pl, start, end = lut
    assert pl == 4
    # every bucket's [start, end) rows must carry that prefix
    from blasr_jax.core.encode import pack_kmers

    keys, _ = pack_kmers(genome, pl)
    for b in (0, 77, 255):
        if end[b] > start[b]:
            seg = rows[int(start[b]) : int(end[b])]
            seg = seg[seg + pl <= len(genome)]
            assert np.all(keys[seg] == b)


def test_sa_file_bad_magic(tmp_path):
    p = str(tmp_path / "bad.sa")
    with open(p, "wb") as f:
        f.write(b"\x00" * 16)
    with pytest.raises(ValueError):
        read_sa_file(p)


@pytest.mark.skipif(
    not os.path.exists(REF_SAWRITER), reason="reference sawritermc not built"
)
def test_sa_file_matches_reference_binary(tmp_path):
    """Our SA-IS order over an ACGT genome equals the reference binary's
    .sa output, and our writer's bytes parse identically."""
    from blasr_jax.index.suffix_array import build_suffix_array

    fa = str(tmp_path / "g.fa")
    codes = _random_fasta(fa, 20_000, seed=11)
    ref_sa = str(tmp_path / "g.fa.ref.sa")
    subprocess.run(
        [REF_SAWRITER, ref_sa, fa], check=True,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    theirs = read_sa_file(ref_sa)
    ours = reference_order_sa(codes)
    np.testing.assert_array_equal(theirs, ours)

    # and the reverse direction: the reference binary must accept OUR file
    # via -sa and produce the same mapping as with its own .sa
    p = str(tmp_path / "ours.sa")
    write_sa_file(p, ours)
    a = bytearray(open(p, "rb").read()[: 16 + 4 * len(ours)])
    b = bytearray(open(ref_sa, "rb").read()[: 16 + 4 * len(theirs)])
    a[8:12] = b[8:12] = b"\x00" * 4  # has-LUT component flag may differ
    assert a == b
    blasrmc = "/tmp/refbuild/alignment/bin/blasrmc"
    if os.path.exists(blasrmc):
        reads = str(tmp_path / "r.fa")
        with open(reads, "w") as f:
            for i, start in enumerate((1000, 7000, 15000)):
                seq = "".join("ACGT"[c] for c in codes[start : start + 400])
                f.write(f">rd{i}\n{seq}\n")
        outs = []
        for sa_file in (p, ref_sa):
            m4 = str(tmp_path / (os.path.basename(sa_file) + ".m4"))
            subprocess.run(
                [blasrmc, reads, fa, "-sa", sa_file, "-m", "4", "-out", m4],
                check=True, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )
            outs.append(open(m4).read())
        assert outs[0] == outs[1] and outs[0].count("\n") == 3


def test_build_index_from_reference_order_sa(tmp_path):
    """blasr -sa FILE: a reference-order .sa (short suffixes interleaved)
    loads and maps identically to a freshly built index."""
    from blasr_jax.index.artifacts import build_index_from_sa, build_index
    from blasr_jax.io.batching import Read
    from blasr_jax.params import MappingParams
    from blasr_jax.pipeline.runner import run_mapping
    from blasr_jax.output.m4 import format_m4

    fa = str(tmp_path / "g.fa")
    codes = _random_fasta(fa, 30_000, seed=3)
    rows = reference_order_sa(codes)
    sa_path = str(tmp_path / "g.fa.sa")
    write_sa_file(sa_path, rows)

    idx_sa = build_index_from_sa(fa, sa_path, k=12)
    idx_new = build_index(fa, k=12)
    reads = [
        Read(f"r{i}/0/0_400", codes[s : s + 400].copy(), None, i)
        for i, s in enumerate((500, 12_000, 25_000))
    ]
    params = MappingParams(batch_size=4, max_read_len=512, n_candidates=2,
                           best_n=1, min_match_length=12)
    ra, _ = run_mapping(idx_sa, reads, params)
    rb, _ = run_mapping(idx_new, reads, params)
    assert [format_m4(r) for r in ra] == [format_m4(r) for r in rb]
    assert len(ra) == 3
