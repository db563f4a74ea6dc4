import numpy as np

from blasr_jax.core.encode import (
    CODE_N,
    codes_to_seq,
    pack_kmers,
    revcomp_codes,
    seq_to_codes,
)


def test_seq_roundtrip():
    s = "ACGTNacgtnXYZ"
    codes = seq_to_codes(s)
    assert codes.tolist() == [0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 4, 4, 4]
    assert codes_to_seq(codes) == "ACGTNACGTNNNN"


def test_revcomp():
    codes = seq_to_codes("ACGTN")
    rc = revcomp_codes(codes)
    assert codes_to_seq(rc) == "NACGT"
    # revcomp twice is identity
    assert np.array_equal(revcomp_codes(rc), codes)


def test_pack_kmers_values():
    codes = seq_to_codes("ACGT")
    keys, valid = pack_kmers(codes, 2)
    # AC=0b0001=1, CG=0b0110=6, GT=0b1011=11, T+padA=0b1100=12
    assert keys.tolist() == [1, 6, 11, 12]
    assert valid.tolist() == [True, True, True, False]


def test_pack_kmers_n_invalid():
    codes = seq_to_codes("ACNGT")
    keys, valid = pack_kmers(codes, 3)
    # windows: ACN, CNG, NGT all contain N; positions 3,4 run past the end
    assert valid.tolist() == [False, False, False, False, False]
    keys2, valid2 = pack_kmers(seq_to_codes("ANCGT"), 3)
    assert valid2.tolist() == [False, False, True, False, False]


def test_pack_kmers_sorted_under_suffix_order():
    # packed keys of suffixes in suffix-array order must be ascending
    from blasr_jax.index.suffix_array import build_suffix_array

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=500).astype(np.uint8)
    sa = build_suffix_array(codes)
    keys, _ = pack_kmers(codes, 7)
    sk = keys[sa]
    assert np.all(sk[1:] >= sk[:-1])
