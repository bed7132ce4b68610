"""Device resolution and the repository root (counterpart of ``musicstyletransfer_tpu/utils.py``)."""

from __future__ import annotations

from pathlib import Path

import torch

REPO_ROOT = Path(__file__).resolve().parent.parent


def resolve_device(gpu: bool = False, cpu: bool = False) -> torch.device:
    """``--gpu`` means CUDA and raises when it is absent; ``--cpu``, or
    neither flag, means the CPU. Nothing carries on on the CPU when a GPU
    was asked for."""
    if gpu and cpu:
        raise ValueError("--gpu and --cpu exclude each other")
    if gpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--gpu asks for CUDA, but torch.cuda.is_available() is False"
            )
        return torch.device("cuda")
    return torch.device("cpu")
