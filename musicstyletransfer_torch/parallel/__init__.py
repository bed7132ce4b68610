"""Multi-process runs: the (data, model) mesh and its tensor-parallel rules
(``mesh.py``), the conjugate collectives of tensor and sequence parallelism
(``collectives.py``) and the process layer (``distributed.py``), used by
training, sharded inference (``inference/sharded.py``, the service and the
engine) and the GAN trainer. Counterpart of
``musicstyletransfer_tpu/parallel/``; pipeline parallelism is not ported
yet."""

from .distributed import (ProcessInfo, ProcessShardedDataset, assert_in_sync,
                          initialize_distributed, make_global_batch, mesh_process_info)
from .mesh import (AXIS_DATA, AXIS_MODEL, Mesh, current_mesh, make_mesh, param_spec,
                   shard_batch, shard_model, shard_params, use_mesh)

__all__ = [
    "AXIS_DATA", "AXIS_MODEL", "Mesh", "ProcessInfo", "ProcessShardedDataset",
    "assert_in_sync", "current_mesh", "initialize_distributed", "make_global_batch",
    "make_mesh", "mesh_process_info", "param_spec", "shard_batch", "shard_model",
    "shard_params", "use_mesh",
]
