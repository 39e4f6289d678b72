"""Keyed partitioning (the port's ``parallel`` package).

Only the numpy-only partitioner is here: the mesh, sharding,
distributed and health modules of the JAX package's ``parallel`` wait for
the parallel slice, and this ``__init__`` pulls none of them in."""

from flink_jpmml_tpu_torch.parallel.partitioner import (  # noqa: F401
    HashPartitioner,
    rendezvous_pick,
    stable_hash,
    stable_hash_vec,
)
