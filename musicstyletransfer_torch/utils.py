"""Device resolution and the repository root (counterpart of ``musicstyletransfer_tpu/utils.py``)."""

from __future__ import annotations

from pathlib import Path

import torch

REPO_ROOT = Path(__file__).resolve().parent.parent


def resolve_device(gpu: bool = False, cpu: bool = False) -> torch.device:
    """The entry points' device: CUDA by default and with ``--gpu``, raising
    when there is no card; the CPU only when ``--cpu`` asks for it. Nothing
    carries on on the CPU when the card is missing."""
    if gpu and cpu:
        raise ValueError("--gpu and --cpu exclude each other")
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on CUDA unless --cpu is given, but "
            "torch.cuda.is_available() is False"
        )
    return torch.device("cuda")
