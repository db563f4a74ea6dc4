"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Must set env vars before jax is imported anywhere.
"""

import os

# The suite runs on a virtual 8-device CPU mesh. Tests marked ``gpu``
# (tests/test_gpu.py) need the card: run them there with
#   JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
# No persistent XLA cache in tests: concurrent shard threads
# (parallel/sharded.py) deserializing the same cache entry segfault in
# jax's _cache_read, and CPU compiles are cheap anyway.
os.environ["BLASR_JAX_NO_CACHE"] = "1"
os.environ.setdefault("JAX_ENABLE_X64", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from blasr_jax.core.encode import seq_to_codes  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """Drop compiled executables between test modules.

    A single serial run of the whole suite accumulates hundreds of live
    XLA:CPU executables in one process; past a threshold, a *later*
    compilation (observed: threaded map_batch compile in the sharded
    tests) segfaults inside backend_compile_and_load. Releasing compiled
    programs per module keeps the process under that threshold; xdist
    runs are unaffected (fresh workers).
    """
    yield
    import jax

    jax.clear_caches()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def random_genome(rng, n, seed_offset=0):
    return rng.integers(0, 4, size=n).astype(np.uint8)


def mutate_read(rng, genome, start, length, sub=0.05, ins=0.06, dele=0.04):
    """Sample a PacBio-like noisy read from genome[start:start+length]."""
    out = []
    i = start
    end = min(start + length, len(genome))
    while i < end:
        r = rng.random()
        if r < ins:
            out.append(rng.integers(0, 4))
        elif r < ins + dele:
            i += 1
        elif r < ins + dele + sub:
            out.append((genome[i] + 1 + rng.integers(0, 3)) % 4)
            i += 1
        else:
            out.append(genome[i])
            i += 1
    return np.asarray(out, dtype=np.uint8)


@pytest.fixture(scope="session")
def small_genome(rng):
    return random_genome(rng, 20000)
