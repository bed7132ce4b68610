"""Samplers and style transfer: encode -> class swap -> decode -> MIDI files
(counterpart of ``musicstyletransfer_tpu/inference/sampler.py``).

Same output names as the reference (``out-{i}.original.mid`` and
``out-{i}.class-{c}.mid``). The model is read from ``<model>/torch/``,
written by ``scripts/export-torch-weights.py``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..data.dataset import Batch, Dataset
from ..midi.codec import MelodyWriter, melody_from_ids

from ..convert import load_npz, params_from_jax
from ..models.config import load_config
from ..models.vae import StyleVAE
from .decode import sample_sequences, style_transfer_all_classes


def load_inference_model(model_folder: str, checkpoint: Optional[int],
                         device: torch.device = torch.device("cpu")) -> StyleVAE:
    """``<model_folder>/torch/{config.json,params.npz}`` -> StyleVAE on
    ``device``, in eval mode. ``checkpoint`` -1 takes the exported one, an
    index must match it, and None keeps freshly initialized weights."""
    export = os.path.join(model_folder, "torch")
    config, exported = load_config(os.path.join(export, "config.json"))
    model = StyleVAE(config)
    if checkpoint is not None:
        if checkpoint not in (-1, exported):
            raise ValueError(
                f"{export} holds checkpoint {exported}, not {checkpoint}; run "
                f"scripts/export-torch-weights.py {model_folder} --checkpoint {checkpoint}"
            )
        model.load_state_dict(params_from_jax(load_npz(os.path.join(export, "params.npz"))))
    return model.to(device).eval()


def get_sampler(type: str, model_folder: Optional[str], checkpoint: Optional[int], args,
                device: torch.device = torch.device("cpu"),
                model: Optional[StyleVAE] = None) -> "SamplerBase":
    if type == "sampling":
        return Sampling(model_folder, checkpoint, device=device, model=model,
                        seed=getattr(args, "seed", 0),
                        temperature=getattr(args, "temperature", 1.0),
                        top_k=getattr(args, "top_k", 0),
                        top_p=getattr(args, "top_p", 0.0))
    if type == "beam-search":
        raise NotImplementedError(
            "beam search is not ported to PyTorch yet (ROADMAP queue 1, item 5)")
    raise ValueError(f"Sampler {type} is not implemented")


class SamplerBase:
    """Loads the model (or shares a given one, as the trainer's in-training
    sampling does) and writes a dataset's transfers as MIDI files;
    subclasses say how a batch is transferred into every class."""

    def __init__(self, model_folder: Optional[str], checkpoint: Optional[int],
                 device: torch.device = torch.device("cpu"),
                 model: Optional[StyleVAE] = None):
        self.device = device
        self.model = (model if model is not None
                      else load_inference_model(model_folder, checkpoint, device))

    def process_dataset(self, dataset: Dataset, output_suffix: str) -> None:
        """Write originals + per-target-class transfers for every batch."""
        os.makedirs(output_suffix, exist_ok=True)
        print("Starting to decode dataset")
        writer = MelodyWriter()
        current = 0
        for bi, batch in enumerate(dataset):
            print(f"Processing batch {bi}")
            self._write_batch(batch, output_suffix, dataset.num_classes(), writer,
                              index_offset=current)
            current += batch.batch_size
        print("Done with dataset decoding")

    def process_batch(self, batch: Batch, output_suffix: str, num_classes: int) -> None:
        """Originals + per-target-class transfers of one batch (reference:
        sampler.py:111-135)."""
        os.makedirs(output_suffix, exist_ok=True)
        self._write_batch(batch, output_suffix, num_classes, MelodyWriter(), index_offset=0)

    def _write_batch(self, batch: Batch, output_suffix: str, num_classes: int,
                     writer: MelodyWriter, index_offset: int) -> None:
        for i, row in enumerate(np.asarray(batch.tokens)):
            writer.write_to_file(
                os.path.join(output_suffix, f"out-{index_offset + i}.original.mid"),
                melody_from_ids(row))
        all_sequences = self.sample_all_classes(batch, num_classes)
        for class_idx in range(num_classes):
            for i, row in enumerate(all_sequences[class_idx]):
                writer.write_to_file(
                    os.path.join(output_suffix,
                                 f"out-{index_offset + i}.class-{class_idx}.mid"),
                    melody_from_ids(row))

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.long, device=self.device)

    def sample_all_classes(self, batch: Batch, num_classes: int) -> np.ndarray:
        """[C, B, T] transfers of the batch into every class."""
        raise NotImplementedError


class Sampling(SamplerBase):
    """Ancestral sampling with temperature / top-k / top-p. Each call draws
    the kernel's Philox key from a ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, model_folder: Optional[str], checkpoint: Optional[int],
                 device: torch.device = torch.device("cpu"), seed: int = 0,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
                 model: Optional[StyleVAE] = None):
        super().__init__(model_folder, checkpoint, device, model)
        self._generator = torch.Generator().manual_seed(seed)
        self.temperature = temperature
        self.top_k = int(top_k)
        self.top_p = float(top_p)

    def _next_seed(self) -> int:
        return int(torch.randint(0, 2 ** 62, (1,), generator=self._generator))

    def sample(self, batch: Batch) -> np.ndarray:
        """[B, T] transfers of the batch into its own ``classes``."""
        max_len = int(batch.tokens.shape[1]) * 2  # reference: sampler.py:164
        seqs, _ = sample_sequences(
            self.model, self._tensor(batch.tokens), self._tensor(batch.seq_lens),
            self._tensor(batch.classes), max_len, self._next_seed(),
            self.temperature, top_k=self.top_k, top_p=self.top_p)
        return seqs.cpu().numpy()

    def sample_all_classes(self, batch: Batch, num_classes: int) -> np.ndarray:
        """[C, B, T]: one encode and one decode for all C target classes."""
        max_len = int(batch.tokens.shape[1]) * 2
        seqs, _ = style_transfer_all_classes(
            self.model, self._tensor(batch.tokens), self._tensor(batch.seq_lens),
            max_len, num_classes, self._next_seed(), self.temperature,
            top_k=self.top_k, top_p=self.top_p)
        return seqs.cpu().numpy()
