"""Samplers and style transfer: encode -> class swap -> decode -> MIDI files
(counterpart of ``musicstyletransfer_tpu/inference/sampler.py``).

Same output names as the reference (``out-{i}.original.mid`` and
``out-{i}.class-{c}.mid``); with ``visualize`` (``--visualize-samples``) a
piano-roll ``<file>.mid.png`` is written beside each MIDI file
(``utils.visualize_melody``, matplotlib optional). Every entry point runs on
the card unless it is given a device (``utils.resolve_device``). The configuration is read from
``<model>/torch/config.json``; the parameters from the port's own checkpoint
``params.N.pt`` where the folder holds one (written by ``cli.main``), else
from the export ``<model>/torch/params.npz`` (``scripts/export-torch-weights.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..data.dataset import Batch, Dataset
from ..midi.codec import MelodyWriter, melody_from_ids

from ..convert import load_npz, params_from_jax
from ..models.config import load_config
from ..models.vae import StyleVAE
from ..training.checkpoint import checkpoint_indices, restore_checkpoint
from ..utils import resolve_device, visualize_melody
from .decode import beam_search, sample_sequences, style_transfer_all_classes


def load_inference_model(model_folder: str, checkpoint: Optional[int],
                         device: Optional[torch.device] = None) -> StyleVAE:
    """The model of ``<model_folder>/torch/config.json`` on ``device`` (None:
    CUDA, raising without a card), in eval mode, with checkpoint
    ``checkpoint``'s parameters (-1: the latest; None keeps freshly
    initialized weights).

    A folder that ``cli.main`` trained holds ``params.N.pt``: its flat
    float32 ``"params"`` (the optimizer's buffer, in the order of
    ``model.parameters()``) are loaded. A folder with only the export
    ``torch/params.npz`` serves the exported checkpoint alone."""
    device = torch.device(device) if device is not None else resolve_device()
    export = os.path.join(model_folder, "torch")
    config, exported = load_config(os.path.join(export, "config.json"))
    model = StyleVAE(config)
    if checkpoint is None:
        return model.to(device).eval()
    indices = checkpoint_indices(model_folder)
    if indices:
        index = indices[-1] if checkpoint == -1 else checkpoint
        if index not in indices:
            raise ValueError(f"{model_folder} holds checkpoints {indices}, not {checkpoint}")
        load_flat_params(model, restore_checkpoint(model_folder, index)["params"])
    else:
        if checkpoint not in (-1, exported):
            raise ValueError(
                f"{export} holds checkpoint {exported}, not {checkpoint}; run "
                f"scripts/export-torch-weights.py {model_folder} --checkpoint {checkpoint}"
            )
        model.load_state_dict(params_from_jax(load_npz(os.path.join(export, "params.npz"))))
    return model.to(device).eval()


def load_flat_params(model: StyleVAE, flat: torch.Tensor) -> None:
    """Copy a checkpoint's flat float32 parameters into ``model``, in the
    order of ``model.parameters()`` (the trainer's optimizer layout)."""
    params = list(model.parameters())
    total = sum(p.numel() for p in params)
    if flat.dim() != 1 or flat.numel() != total:
        raise ValueError(f"{flat.numel()} parameters in the checkpoint, {total} in the model")
    offset = 0
    with torch.no_grad():
        for p in params:
            p.copy_(flat[offset:offset + p.numel()].view_as(p))
            offset += p.numel()


def get_sampler(type: str, model_folder: Optional[str], checkpoint: Optional[int], args,
                device: Optional[torch.device] = None,
                model: Optional[StyleVAE] = None) -> "SamplerBase":
    """The sampler ``type`` names (``--sampling-type``), with ``args``'
    sampling flags and ``--visualize-samples``."""
    visualize = getattr(args, "visualize_samples", False)
    if type == "sampling":
        return Sampling(model_folder, checkpoint, device=device, model=model,
                        visualize=visualize, seed=getattr(args, "seed", 0),
                        temperature=getattr(args, "temperature", 1.0),
                        top_k=getattr(args, "top_k", 0),
                        top_p=getattr(args, "top_p", 0.0))
    if type == "beam-search":
        return BeamSearchSampler(model_folder, checkpoint, device=device, model=model,
                                 visualize=visualize, beam_size=args.beam_size,
                                 length_penalty=getattr(args, "length_penalty", 0.0))
    raise ValueError(f"Sampler {type} is not implemented")


class SamplerBase:
    """Loads the model (or shares a given one, as the trainer's in-training
    sampling does) and writes a dataset's transfers as MIDI files;
    subclasses say how a batch is transferred into every class. ``device``
    None is a given model's device, else CUDA (raising without a card)."""

    def __init__(self, model_folder: Optional[str], checkpoint: Optional[int],
                 device: Optional[torch.device] = None,
                 model: Optional[StyleVAE] = None, visualize: bool = False):
        if device is None:
            device = model.device if model is not None else resolve_device()
        self.device = torch.device(device)
        self.visualize = visualize
        self.model = (model if model is not None
                      else load_inference_model(model_folder, checkpoint, self.device))

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
            self._write_melody(writer, melody_from_ids(row), os.path.join(
                output_suffix, f"out-{index_offset + i}.original.mid"))
        all_sequences = self.sample_all_classes(batch, num_classes)
        for class_idx in range(num_classes):
            for i, row in enumerate(all_sequences[class_idx]):
                self._write_melody(writer, melody_from_ids(row), os.path.join(
                    output_suffix, f"out-{index_offset + i}.class-{class_idx}.mid"))

    def _write_melody(self, writer: MelodyWriter, melody, path: str) -> None:
        """The MIDI file, and with ``visualize`` its piano roll beside it
        (``sampler.py:157-163`` of the JAX package)."""
        writer.write_to_file(path, melody)
        if self.visualize and len(melody):
            visualize_melody(melody, path + ".png")

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.long, device=self.device)

    def sample_all_classes(self, batch: Batch, num_classes: int) -> np.ndarray:
        """[C, B, T] transfers of the batch into every class: ``sample`` once
        per class, the batch's classes overwritten (reference:
        sampler.py:93-95)."""
        return np.stack([self.sample(dataclasses.replace(
            batch, classes=np.full_like(batch.classes, c))) for c in range(num_classes)])

    def sample(self, batch: Batch) -> np.ndarray:
        """[B, T] transfers of the batch into its own ``classes``."""
        raise NotImplementedError


class Sampling(SamplerBase):
    """Ancestral sampling with temperature / top-k / top-p. Each call draws
    the kernel's Philox key from a ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, model_folder: Optional[str], checkpoint: Optional[int],
                 device: Optional[torch.device] = None, seed: int = 0,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
                 model: Optional[StyleVAE] = None, visualize: bool = False):
        super().__init__(model_folder, checkpoint, device, model, visualize)
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


class BeamSearchSampler(SamplerBase):
    """Batched beam search (``sampler.py:234-256`` of the JAX package), at
    max_len twice the source's length."""

    def __init__(self, model_folder: Optional[str], checkpoint: Optional[int],
                 device: Optional[torch.device] = None, beam_size: int = 5,
                 length_penalty: float = 0.0, model: Optional[StyleVAE] = None,
                 visualize: bool = False):
        super().__init__(model_folder, checkpoint, device, model, visualize)
        self.beam_size = beam_size
        self.length_penalty = length_penalty
        self.max_length_factor = 2.0

    def sample(self, batch: Batch) -> np.ndarray:
        max_len = int(batch.tokens.shape[1] * self.max_length_factor)
        seqs, _ = beam_search(self.model, self._tensor(batch.tokens),
                              self._tensor(batch.seq_lens), self._tensor(batch.classes),
                              max_len, self.beam_size, self.length_penalty)
        return seqs.cpu().numpy()
