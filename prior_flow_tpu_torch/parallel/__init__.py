"""Data and spatial parallelism over a ``torch.distributed`` process group
(counterpart of ``prior_flow_tpu/parallel``): the mesh and batch sharding
(``mesh.py``), the height sharding of the ``space`` axis
(``spatial.py``), and spawned runs over ranks (``dryrun.py``)."""

from .dryrun import dryrun_multichip, spawn
from .mesh import (Mesh, all_reduce_grads, all_reduce_sums, batch_sharding,
                   close_mesh, height_sharding, make_mesh, make_mesh_2d,
                   replicated, shard_batch, spatial_batch_sharding)

__all__ = ["Mesh", "all_reduce_grads", "all_reduce_sums", "batch_sharding",
           "close_mesh", "dryrun_multichip", "height_sharding", "make_mesh",
           "make_mesh_2d", "replicated", "shard_batch",
           "spatial_batch_sharding", "spawn"]
