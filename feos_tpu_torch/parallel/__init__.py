"""Data parallelism over the batch, one process per card."""

from .mesh import (
    BatchMesh, all_reduce_sum, batch_mesh, data_parallel, gather_batch,
    initialize_multi_host, pad_to_multiple, shard_batch,
)

__all__ = [
    "BatchMesh", "all_reduce_sum", "batch_mesh", "data_parallel", "gather_batch",
    "initialize_multi_host", "pad_to_multiple", "shard_batch",
]
