from blasr_jax.index.suffix_array import build_suffix_array  # noqa: F401
from blasr_jax.index.artifacts import GenomeIndex, build_index, load_index  # noqa: F401
