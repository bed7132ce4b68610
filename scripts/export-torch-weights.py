#!/usr/bin/env python
"""Export a model folder's Orbax checkpoint for the PyTorch port.

    python scripts/export-torch-weights.py models/guitar_bass [--checkpoint N]
    python scripts/export-torch-weights.py models/gan_guitar_bass [--checkpoint N]

Runs under JAX (it restores ``params.N`` with the JAX package) and writes

- ``<model>/torch/params.npz``: every parameter as float32, keyed by its
  ``/``-joined flax path (``decoder/decoder/layer0/attention/w_q/kernel``),
  uncompressed;
- ``<model>/torch/config.json``: ``{"checkpoint": N, "model_config": {...}}``,
  the ``ModelConfig`` as plain dicts.

A GAN folder (a ``generator/`` checkpoint folder beside the config) exports
its generator (``generator/params.N``, flax paths such as
``cell/lstm0/ii/kernel``) and ``{"checkpoint": N, "gan_config": {...}}``;
``musicstyletransfer_torch.cli.gan --generate`` reads them.

``musicstyletransfer_torch`` reads both with numpy and the standard library
alone, so the port never needs JAX, Orbax or YAML.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, Optional

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def is_gan_folder(model_folder: str) -> bool:
    return os.path.isdir(os.path.join(model_folder, "generator"))


def restore(model_folder: str, checkpoint: int):
    """(checkpoint index, flax param tree, config blob) of a VAE or GAN
    folder's checkpoint (-1 = latest)."""
    from musicstyletransfer_tpu.training import checkpoint as ckpt

    if is_gan_folder(model_folder):
        import jax

        from musicstyletransfer_tpu.models.config import Config
        from musicstyletransfer_tpu.models.gan import init_gan_params

        gen_folder = os.path.join(model_folder, "generator")
        if checkpoint == -1:
            checkpoint = ckpt.get_latest_checkpoint_index(gen_folder)
        config = Config.load(os.path.join(model_folder, "config"))
        template, _ = init_gan_params(config, jax.random.key(0))
        params = ckpt.restore_params(gen_folder, checkpoint, template)
        return checkpoint, params, {"gan_config": dataclasses.asdict(config)}

    from musicstyletransfer_tpu.inference.sampler import load_inference_model

    if checkpoint == -1:
        checkpoint = ckpt.get_latest_checkpoint_index(model_folder)
    model, params = load_inference_model(model_folder, checkpoint)
    return checkpoint, params, {"model_config": dataclasses.asdict(model.config)}


def export_params(model_folder: str, checkpoint: int = -1,
                  out_dir: Optional[str] = None) -> str:
    """Restore ``params.<checkpoint>`` (-1 = latest; a GAN folder's
    generator) and write the two files into ``out_dir`` (default
    ``<model_folder>/torch``). Returns ``out_dir``."""
    from flax import traverse_util

    checkpoint, params, config = restore(model_folder, checkpoint)
    flat: Dict[str, np.ndarray] = {
        k: np.asarray(v, np.float32)
        for k, v in traverse_util.flatten_dict(params, sep="/").items()
    }
    out_dir = out_dir or os.path.join(model_folder, "torch")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "params.npz"), **flat)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({"checkpoint": int(checkpoint), **config}, f, indent=2, sort_keys=True)
        f.write("\n")
    n = sum(int(v.size) for v in flat.values())
    print(f"exported {len(flat)} arrays, {n} parameters, "
          f"checkpoint {checkpoint} -> {out_dir}")
    return out_dir


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("model_folder")
    p.add_argument("--checkpoint", "-c", type=int, default=-1,
                   help="checkpoint index (-1 = latest)")
    p.add_argument("--out-dir", default=None,
                   help="default: <model_folder>/torch")
    args = p.parse_args(argv)
    from musicstyletransfer_tpu.utils import respect_platforms_env

    respect_platforms_env()
    export_params(args.model_folder, args.checkpoint, args.out_dir)


if __name__ == "__main__":
    main()
