"""Data parallelism (port of pytorch_segmentation_tpu/parallel/): the mesh
and its placement helpers (`mesh.py`) and ZeRO-1 (`zero.py`). The JAX
package's `--spatial` mesh, `tp.py`, `pp.py` and `ep.py` are not ported
(ROADMAP queue 1 item 10)."""

from .mesh import (DataSharding, Mesh, ReplicatedSharding, data_sharding,
                   initialize_distributed, make_mesh, put_global_batch,
                   put_replicated_tree, replicas, replicated_sharding,
                   shard_batch, split_batch)
from .zero import ZeroOptimizer, zero_leaf_spec

__all__ = ["DataSharding", "Mesh", "ReplicatedSharding", "ZeroOptimizer",
           "data_sharding", "initialize_distributed", "make_mesh",
           "put_global_batch", "put_replicated_tree", "replicas",
           "replicated_sharding", "shard_batch", "split_batch",
           "zero_leaf_spec"]
