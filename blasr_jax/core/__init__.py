from blasr_jax.core.encode import (  # noqa: F401
    CODE_A,
    CODE_C,
    CODE_G,
    CODE_N,
    CODE_T,
    SIGMA,
    codes_to_seq,
    pack_kmers,
    revcomp_codes,
    seq_to_codes,
)
