"""Flax parameter tree <-> ``StyleVAE`` state_dict.

The flax names of ``musicstyletransfer_tpu/models/vae.py`` carry over
path for path (``/`` becomes ``.``), with four renames:

- a Dense ``kernel`` is [in, out]; a torch ``Linear.weight`` is [out, in],
  so it takes ``kernel.T`` (``w_q/w_k/w_v`` are ``_ProjParams`` in the same
  layout, ``transformer.py:72-92``);
- an Embed ``embedding`` becomes ``weight``;
- a LayerNorm ``scale`` becomes ``weight``;
- ``layer{i}`` of a stack becomes ``layers.{i}`` (an ``nn.ModuleList``).

``params_to_jax`` is the inverse: the port's trainer writes its checkpoints'
``torch/params.npz`` with it, in the layout ``scripts/export-torch-weights.py``
writes.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested flax tree of arrays, or a flat ``/``-joined dict -> state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(tree).items():
        parts = path.split("/")
        leaf = parts[-1]
        if leaf == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{path}: expected a 2-D Dense kernel, got {arr.shape}")
            arr, leaf = arr.T, "weight"
        elif leaf in ("embedding", "scale"):
            leaf = "weight"
        elif leaf != "bias":
            raise ValueError(f"{path}: unknown flax parameter {leaf!r}")
        name = ".".join(parts[:-1] + [leaf])
        name = re.sub(r"(^|\.)layer(\d+)\.", r"\1layers.\2.", name)
        sd[name] = torch.tensor(np.asarray(arr, dtype=np.float32))
    return sd


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """The flat ``/``-keyed arrays of an export's ``params.npz``."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def params_to_jax(model: nn.Module) -> Dict[str, np.ndarray]:
    """``model``'s parameters as the flat ``/``-keyed float32 arrays of an
    export's ``params.npz`` (flax names and layouts)."""
    out: Dict[str, np.ndarray] = {}
    for mod_name, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            arr = p.detach().float().cpu().numpy()
            if isinstance(module, nn.Embedding):
                leaf = "embedding"
            elif isinstance(module, nn.LayerNorm):
                leaf = "scale" if leaf == "weight" else leaf
            elif leaf == "weight":
                arr, leaf = arr.T, "kernel"
            name = re.sub(r"(^|\.)layers\.(\d+)(?=\.|$)", r"\1layer\2", mod_name)
            out["/".join(name.split(".") + [leaf])] = np.ascontiguousarray(arr)
    return out
