from blasr_jax.parallel.mesh import (  # noqa: F401
    make_mesh,
    replicate_index,
    shard_batch,
    sharded_map_batch,
)
