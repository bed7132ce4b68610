"""Corpus loading and batching: the port's copies of the JAX package's
``data`` modules (numpy only)."""

from .dataset import (
    Batch,
    Dataset,
    MelodyDataset,
    RawBatch,
    ToyData,
    chunk_melodies,
    layout_chunks,
    load_dataset,
    tensorize_melodies,
)
from .loader import Loader

__all__ = [
    "Batch",
    "Dataset",
    "Loader",
    "MelodyDataset",
    "RawBatch",
    "ToyData",
    "chunk_melodies",
    "layout_chunks",
    "load_dataset",
    "tensorize_melodies",
]
