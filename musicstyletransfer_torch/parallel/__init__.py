"""Multi-process runs: the (data, model) mesh and its tensor-parallel rules
(``mesh.py``), the conjugate collectives of tensor and sequence parallelism
(``collectives.py``), the process layer (``distributed.py``) and pipeline
parallelism over the model axis (``pipeline.py``, and the pipelined
``TransformerStack`` of ``transformer_pipeline.py``), used by training,
sharded inference (``inference/sharded.py``, the service and the engine)
and the GAN trainer. Counterpart of ``musicstyletransfer_tpu/parallel/``."""

from .distributed import (ProcessInfo, ProcessShardedDataset, assert_in_sync,
                          initialize_distributed, make_global_batch, mesh_process_info)
from .mesh import (AXIS_DATA, AXIS_MODEL, Mesh, current_mesh, make_mesh, param_spec,
                   shard_batch, shard_model, shard_params, use_mesh)
from .pipeline import pipeline_apply, pipeline_apply_lockstep
from .transformer_pipeline import (pipeline_transformer_stack, stack_stage_params,
                                   transformer_stage_fn)

__all__ = [
    "AXIS_DATA", "AXIS_MODEL", "Mesh", "ProcessInfo", "ProcessShardedDataset",
    "assert_in_sync", "current_mesh", "initialize_distributed", "make_global_batch",
    "make_mesh", "mesh_process_info", "param_spec", "pipeline_apply",
    "pipeline_apply_lockstep", "pipeline_transformer_stack", "shard_batch", "shard_model",
    "shard_params", "stack_stage_params", "transformer_stage_fn", "use_mesh",
]
