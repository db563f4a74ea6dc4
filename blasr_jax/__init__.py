"""blasr_jax — a GPU long-read alignment framework in JAX.

A from-scratch re-design of the capabilities of BLASR (the PacBio long-read
aligner, reference: mchaisso/blasr) for an accelerator, an NVIDIA GPU
(tests run the same programs on the CPU):

  * host side  — FASTA/FASTQ/SAM ingest, suffix-array index construction,
                 traceback replay, output formatting (C++/numpy)
  * device side — batched suffix-array anchor search, diagonal-bin candidate
                 selection, anchor chaining, and wavefront banded affine-gap
                 dynamic programming, as JAX/XLA programs over padded read
                 batches, with the banded DP as a CUDA kernel on the GPU;
                 scaled over device meshes with jax.sharding + shard_map.

Layer map (mirrors reference layers L0-L7 described in SURVEY.md):

  core/      L0  sequence encoding (2-bit codes, packing, revcomp)
  io/        L1  FASTA/FASTQ/SAM readers, seq database, read batching
  index/     L2  suffix array + k-mer lookup index ("sawriter" equivalent)
  ops/       L3+L4 device compute: anchoring, chaining, banded DP, MAPQ
  pipeline/  L5  per-batch mapping orchestration + host traceback
  output/    L6  SAM / m0-m5 formatters
  cli/       L7  command-line drivers (blasr-jax, sawriter-jax)
  parallel/  —   mesh construction, sharded mapping step
"""

__version__ = "0.1.0"

import os as _os

_CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compilation_cache_dir() -> str:
    """Where compiled programs persist across processes.

    ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself);
    otherwise one fixed, git-ignored directory inside the checkout, so that
    every run from this checkout finds what an earlier run compiled.
    """
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _CHECKOUT, ".jax_cache"
    )


def _setup_compilation_cache() -> None:
    """The mapping step compiles once per (batch, length-bucket) shape and a
    cold compile of the full pipeline takes tens of seconds, so a
    persistent on-disk cache (shared by CLI runs, tests and bench) is part
    of the framework's startup path, mirroring the reference's build-once
    index auto-discovery ethos (Blasr.cpp:4375-4449).
    """
    if _os.environ.get("BLASR_JAX_NO_CACHE"):
        return
    import jax

    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", compilation_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_setup_compilation_cache()

from blasr_jax.params import MappingParams  # noqa: F401
