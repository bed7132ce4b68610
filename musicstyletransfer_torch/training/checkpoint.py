"""Checkpoint and resume of the port's training (counterpart of
``musicstyletransfer_tpu/training/checkpoint.py``, without Orbax and the
multi-host logic).

A checkpoint N of a model folder is

- ``params.N.pt``: ``torch.save`` of the flat float32 parameters, the Adam
  state, the step, the training generator's state and the training data
  order's numpy generator state (written to a temporary name, then renamed);
- ``train_state.json``: the ``TrainingProgress`` bookkeeping, as in the JAX
  package;
- ``torch/params.npz`` and ``torch/config.json``: the newest parameters in
  the export layout that ``inference.sampler.load_inference_model`` (and so
  ``cli.sample``) reads, with ``"checkpoint": N``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..convert import params_to_jax

_CKPT_RE = re.compile(r"^params\.(\d+)\.pt$")
TRAIN_STATE_FILE = "train_state.json"
EXPORT_DIR = "torch"


@dataclasses.dataclass
class TrainingProgress:
    """Bookkeeping across checkpoints (reference TrainingState, trainer.py:60-65)."""

    n_checkpoints: int = 0
    n_batches: int = 0
    num_checkpoints_not_improved: int = 0
    best_reconstruction_loss: float = float("inf")

    def save(self, model_folder: str) -> None:
        with open(os.path.join(model_folder, TRAIN_STATE_FILE), "w") as fh:
            json.dump(dataclasses.asdict(self), fh)

    @classmethod
    def load(cls, model_folder: str) -> "TrainingProgress":
        with open(os.path.join(model_folder, TRAIN_STATE_FILE)) as fh:
            return cls(**json.load(fh))


def checkpoint_indices(model_folder: str) -> List[int]:
    """Sorted checkpoint indices present in the folder (may be empty)."""
    if not os.path.isdir(model_folder):
        return []
    return sorted(int(m.group(1))
                  for m in (_CKPT_RE.match(n) for n in os.listdir(model_folder)) if m)


def get_latest_checkpoint_index(model_folder: str) -> int:
    """The largest N of the folder's ``params.N.pt``; ValueError when there
    is none."""
    indices = checkpoint_indices(model_folder)
    if not indices:
        raise ValueError(f"No checkpoints found in {model_folder}")
    return indices[-1]


def try_latest(model_folder: str) -> Optional[int]:
    """``get_latest_checkpoint_index``, or None where there is no checkpoint."""
    try:
        return get_latest_checkpoint_index(model_folder)
    except (ValueError, FileNotFoundError):
        return None


def checkpoint_path(model_folder: str, index: int) -> str:
    return os.path.join(model_folder, f"params.{index}.pt")


def save_checkpoint(model_folder: str, index: int, state: Dict[str, Any]) -> None:
    """Write ``params.<index>.pt`` atomically (tensors moved to the CPU)."""
    def to_cpu(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu()
        if isinstance(x, dict):
            return {k: to_cpu(v) for k, v in x.items()}
        return x

    path = checkpoint_path(model_folder, index)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(to_cpu(state), tmp)
    os.replace(tmp, path)


def restore_checkpoint(model_folder: str, index: int) -> Dict[str, Any]:
    return torch.load(checkpoint_path(model_folder, index), map_location="cpu",
                      weights_only=False)


def restore_params(model_folder: str, index: int,
                   params_template: Optional[torch.nn.Module] = None):
    """Only the parameters of checkpoint ``index``: the flat float32 vector,
    or, given a module, ``{name: tensor}`` in its parameters' order and
    shapes (ValueError where the sizes differ)."""
    flat = restore_checkpoint(model_folder, index)["params"]
    if params_template is None:
        return flat
    named = list(params_template.named_parameters())
    total = sum(p.numel() for _, p in named)
    if flat.numel() != total:
        raise ValueError(f"checkpoint {index} holds {flat.numel()} parameters, the template "
                         f"{total}")
    out, offset = {}, 0
    for name, p in named:
        out[name] = flat[offset:offset + p.numel()].view(p.shape).clone()
        offset += p.numel()
    return out


def export_inference(model_folder: str, index: int, model: torch.nn.Module) -> None:
    """``<model_folder>/torch/{params.npz,config.json}`` for the sampler."""
    out = os.path.join(model_folder, EXPORT_DIR)
    os.makedirs(out, exist_ok=True)
    tmp = os.path.join(out, f"params.{os.getpid()}.tmp.npz")
    np.savez(tmp, **params_to_jax(model))
    os.replace(tmp, os.path.join(out, "params.npz"))
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump({"checkpoint": int(index),
                   "model_config": dataclasses.asdict(model.config)},
                  f, indent=2, sort_keys=True)
        f.write("\n")


def prune_checkpoints(model_folder: str, keep: int) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    for idx in checkpoint_indices(model_folder)[:-keep]:
        os.remove(checkpoint_path(model_folder, idx))
