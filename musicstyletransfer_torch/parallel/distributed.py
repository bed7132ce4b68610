"""Multi-process runs: the process group, process identity, process-sharded
data and cross-process checks (counterpart of
``musicstyletransfer_tpu/parallel/distributed.py``).

One process per card: ``initialize_distributed`` joins the world over TCP
(NCCL for a CUDA device, gloo for the CPU), ``parallel.mesh.make_mesh`` lays
the ranks out as the (data, model) grid, and every process reads the same
shuffled global batches and keeps its data rank's rows
(``ProcessShardedDataset``). The JAX package's virtual CPU devices
(``--dist-num-cpu-devices``) have no counterpart: a torch process drives one
device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh


def initialize_distributed(coordinator: str, num_processes: int, process_id: int,
                           device: Optional[torch.device] = None) -> None:
    """``init_process_group`` over ``tcp://<coordinator>`` (host:port of
    process 0), NCCL when ``device`` is a CUDA device (made this process's
    current device), else gloo. Raises when the world cannot form."""
    device = torch.device(device if device is not None else "cpu")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside a world of {num_processes}")
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        # The NCCL collectives of a training group are captured in its CUDA
        # graph (training/graph.py), which PyTorch's capture notes ask to
        # run without the asynchronous error handler.
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
        kwargs["device_id"] = device
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id, **kwargs)


@dataclasses.dataclass(frozen=True)
class ProcessInfo:
    """A process's index among ``count``."""

    index: int
    count: int

    @property
    def is_primary(self) -> bool:
        return self.index == 0


def mesh_process_info(mesh: Mesh) -> ProcessInfo:
    """This process among the mesh's (one a rank)."""
    return ProcessInfo(index=mesh.rank, count=mesh.world)


def data_process_info(mesh: Mesh) -> ProcessInfo:
    """This process's block of every global batch: its data rank among the
    data axis (the ranks of one data index, which differ in model index,
    read the same rows)."""
    return ProcessInfo(index=mesh.data_rank, count=mesh.dp)


def make_global_batch(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global batch from every data rank's rows of it, in data-rank
    order (an all-gather over the data group; ``make_global_batch``'s
    counterpart, whose global arrays the port does not need to train)."""
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.dp)]
    dist.all_gather(parts, local, group=mesh.data_group)
    return torch.cat(parts)


def assert_in_sync(mesh: Mesh, value: float, what: str) -> None:
    """Raise unless every process of the mesh holds the same ``value`` (a
    real collective over the world: it catches a resume where only some
    processes found the checkpoint because the model folder is not shared)."""
    if mesh.world == 1:
        return
    x = torch.tensor([float(value)], dtype=torch.float64, device=mesh.device)
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x)
    values = torch.cat(parts)
    spread = float(values.max() - values.min())
    if spread != 0.0:
        raise RuntimeError(
            f"processes disagree on {what} (spread {spread}); in multi-process runs "
            "model_folder (and the corpus) must be shared storage visible to every process")


class ProcessShardedDataset:
    """Each process iterates the same deterministic batch stream (the same
    dataset seed everywhere) and keeps its rows of each batch: batch_size /
    info.count of them, block ``info.index``. The global batch stays
    ``batch_size``."""

    def __init__(self, dataset, info: ProcessInfo):
        if dataset.batch_size % info.count != 0:
            raise ValueError(f"global batch {dataset.batch_size} not divisible by "
                             f"{info.count} processes")
        self._dataset = dataset
        self._info = info
        self._rows = dataset.batch_size // info.count

    def num_classes(self) -> int:
        return self._dataset.num_classes()

    def num_tokens(self) -> int:
        return self._dataset.num_tokens()

    @property
    def batch_size(self) -> int:
        return self._dataset.batch_size

    @property
    def local_batch_size(self) -> int:
        return self._rows

    def __getattr__(self, name):
        return getattr(self._dataset, name)

    def __iter__(self):
        lo = self._info.index * self._rows
        for batch in self._dataset:
            yield _slice_batch(batch, lo, lo + self._rows)


def _slice_batch(batch: Any, lo: int, hi: int) -> Any:
    """Rows [lo, hi) of a batch dataclass; ``n_valid`` becomes the count of
    real (not wrap-padding) rows inside the slice."""
    fields = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if f.name == "n_valid":
            fields[f.name] = int(np.clip(batch.num_valid - lo, 0, hi - lo))
        else:
            fields[f.name] = v[lo:hi]
    return type(batch)(**fields)
