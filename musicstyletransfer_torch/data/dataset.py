"""Datasets and the tensorizer: tokenized melodies -> static-shape batches.

The PyTorch port's own copy of the numpy half of
``musicstyletransfer_tpu/data/dataset.py`` (the port imports nothing of the
JAX package). ``device_layout_chunks`` and ``device_tensorize``, the JAX
halves, are not copied: the port lays batches out on the host
(``layout_chunks``) and ships the four arrays.

Reference: VarAutoEncoder/data.py:42-223 (Dataset, ToyData, MelodyDataset,
load_dataset). TPU-first divergences from the reference, all documented:

- **Static shapes.** Batches are always ``(batch_size, max_seq_len + 1)``.
  The reference trims each batch to its longest sequence (data.py:196-198);
  under jit that would force a recompile per length, so we pad-and-mask
  instead. ``seq_lens`` carries the true lengths.
- **Per-row EOS.** The reference's ``labels[:, seq_lens] = EOS`` writes EOS
  at *every* row's set of seq_len columns (broken fancy indexing,
  SURVEY.md §8.2). We write one EOS per row at its own length — the evident
  intent.
- **No degenerate chunks.** The reference appends an all-PAD chunk when a
  melody's length is an exact multiple of max_seq_len and duplicates the
  last melody's tail chunk once per class (data.py:133-160). We emit each
  non-empty chunk exactly once.
- **Wrap-padded final batch.** Like ``mx.io.NDArrayIter``'s default
  ``last_batch_handle='pad'``, the last partial batch is filled by wrapping
  to the start, so every batch has the full static batch size.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..midi.codec import Melody
from ..midi.vocab import EOS_ID, NUM_EVENTS, PAD_ID, SOS_ID


@dataclasses.dataclass(frozen=True)
class Batch:
    """One training batch (host numpy; device transfer is the trainer's job).

    tokens:   (B, L+1) int32 — SOS-prefixed, PAD-padded input ids
    seq_lens: (B,)    int32 — # non-PAD input tokens (includes the SOS)
    classes:  (B,)    int32 — style class ids
    labels:   (B, L+1) int32 — target ids with per-row EOS, PAD elsewhere
    n_valid:  rows [n_valid:] are wrap-padding duplicates of earlier rows
              (kept for static shapes); ``None`` means every row is real.
              Evaluation masks the duplicates out so aggregate metrics
              don't double-count them.
    """

    tokens: np.ndarray
    seq_lens: np.ndarray
    classes: np.ndarray
    labels: np.ndarray
    n_valid: Optional[int] = None

    @property
    def batch_size(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def num_valid(self) -> int:
        return self.batch_size if self.n_valid is None else int(self.n_valid)


@dataclasses.dataclass(frozen=True)
class RawBatch:
    """A batch BEFORE tensor layout: raw PAD-padded token chunks.

    In the JAX package the device-layout input path ships these to the
    accelerator; the port's trainer lays them out on the host with
    ``to_batch`` (reference equivalent: data.py:133-198 does all of it on
    host per batch).

    chunks:  (B, L) int32 — melody event ids, PAD-padded
    classes: (B,)  int32 — style class ids
    n_valid: as in ``Batch``
    """

    chunks: np.ndarray
    classes: np.ndarray
    n_valid: Optional[int] = None

    @property
    def batch_size(self) -> int:
        return int(self.chunks.shape[0])

    @property
    def num_valid(self) -> int:
        return self.batch_size if self.n_valid is None else int(self.n_valid)

    def to_batch(self) -> "Batch":
        """Host-side layout for consumers that need concrete tensors
        (e.g. the sampler writing original MIDI)."""
        chunks = np.asarray(self.chunks)
        tokens, seq_lens, labels = layout_chunks(chunks)
        return Batch(tokens=tokens, seq_lens=seq_lens,
                     classes=np.asarray(self.classes), labels=labels,
                     n_valid=self.n_valid)


class Dataset:
    """Reference: data.py:42-54."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size

    def num_classes(self) -> int:
        raise NotImplementedError

    def num_tokens(self) -> int:
        raise NotImplementedError

    def __iter__(self) -> Iterator[Batch]:
        raise NotImplementedError


class ToyData(Dataset):
    """Hardcoded 3-sequence smoke dataset (reference: data.py:57-81)."""

    def __init__(self, batch_size: int = 3):
        super().__init__(batch_size)
        self._tokens = np.array(
            [[1, 5, 6, 7, 0], [1, 6, 7, 8, 0], [1, 7, 8, 9, 0]], dtype=np.int32
        )
        self._seq_lens = np.array([4, 4, 4], dtype=np.int32)
        self._classes = np.array([0, 1, 2], dtype=np.int32)
        self._labels = np.array(
            [[5, 6, 7, 2, 0], [6, 7, 8, 2, 0], [7, 8, 9, 2, 0]], dtype=np.int32
        )

    def num_classes(self) -> int:
        return 3

    def num_tokens(self) -> int:
        return 10

    def __iter__(self) -> Iterator[Batch]:
        yield Batch(self._tokens, self._seq_lens, self._classes, self._labels)


def chunk_melodies(
    melodies: Dict[str, List[Melody]], max_seq_len: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Host half of the tokenize->tensorize pipeline: chop each melody's
    event-id stream into PAD-padded ``max_seq_len`` chunks.

    Returns (chunks (N, L) int32, classes (N,) int32). Classes are indexed
    in sorted-name order (reference: data.py:100).
    """
    L = max_seq_len
    rows: List[np.ndarray] = []
    classes: List[int] = []
    for class_idx, class_melodies in enumerate(
        v for _, v in sorted(melodies.items(), key=lambda kv: kv[0])
    ):
        for melody in class_melodies:
            toks = np.asarray(melody.tokens, dtype=np.int32)
            for start in range(0, max(len(toks), 1), L):
                chunk = toks[start : start + L]
                if len(chunk) == 0:
                    continue
                rows.append(chunk)
                classes.append(class_idx)

    n = len(rows)
    assert n > 0, "Empty sequences were found"
    chunks = np.full((n, L), PAD_ID, dtype=np.int32)
    for i, row in enumerate(rows):
        chunks[i, : len(row)] = row
    return chunks, np.asarray(classes, dtype=np.int32)


def layout_chunks(chunks: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """SOS/EOS/seq_lens layout on HOST numpy (vectorized).

    chunks (N, L) -> (tokens (N, L+1), seq_lens (N,), labels (N, L+1)).
    Equal to the JAX package's ``layout_chunks`` (tested).
    """
    n, L = chunks.shape
    lens = np.sum(chunks != PAD_ID, axis=1)
    tokens = np.concatenate(
        [np.full((n, 1), SOS_ID, chunks.dtype), chunks], axis=1
    )
    shifted = np.concatenate(
        [chunks, np.full((n, 1), PAD_ID, chunks.dtype)], axis=1
    )
    labels = np.where(np.arange(L + 1)[None, :] == lens[:, None],
                      EOS_ID, shifted)
    return tokens, (lens + 1).astype(np.int32), labels


def tensorize_melodies(
    melodies: Dict[str, List[Melody]], max_seq_len: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Chunk + pad + SOS/EOS layout (reference: data.py:133-173, fixed §8.2).

    Returns (tokens (N, L+1), seq_lens (N,), classes (N,), labels (N, L+1)).
    """
    chunks, classes = chunk_melodies(melodies, max_seq_len)
    tokens, seq_lens, labels = layout_chunks(chunks)
    return tokens, seq_lens, classes, labels


class MelodyDataset(Dataset):
    """Tensorized, shuffling, statically-shaped batch source.

    Reference: data.py:84-198 (MelodyDataset).
    """

    def __init__(
        self,
        batch_size: int,
        maximum_sequence_length: int,
        melodies: Dict[str, List[Melody]],
        shuffle: bool = True,
        seed: int = 0,
        device_layout: bool = False,
    ):
        """``device_layout=True`` makes iteration yield ``RawBatch``es (raw
        chunks only; ``RawBatch.to_batch`` lays them out); ``False`` yields
        fully laid-out host ``Batch``es."""
        super().__init__(batch_size)
        self.max_seq_len = maximum_sequence_length
        self.shuffle = shuffle
        self.device_layout = device_layout
        self._rng = np.random.default_rng(seed)
        self.n_classes = len(melodies)
        self.n_melodies = sum(len(m) for m in melodies.values())
        self.seen_max_sequence_length = max(
            (len(m) for ms in melodies.values() for m in ms), default=0
        )
        self.class_names = sorted(melodies.keys())
        self.chunks, self.classes = chunk_melodies(
            melodies, maximum_sequence_length
        )
        if device_layout:
            self.tokens = self.seq_lens = self.labels = None
        else:
            self.tokens, self.seq_lens, self.labels = layout_chunks(self.chunks)
        self._log_dataset(melodies)

    def _log_dataset(self, melodies) -> None:
        print("")
        print("Dataset information: ")
        print(f"Number of classes: {self.num_classes()}")
        print(f"Number of tokens: {self.num_tokens()}")
        print(f"Tokens dataset shape {self.chunks.shape}")
        print(f"Classes dataset shape {self.classes.shape}")
        for c, m in sorted(melodies.items()):
            print(f"Class {c} has {len(m)} melodies")
        print("")

    def num_classes(self) -> int:
        return self.n_classes

    def num_tokens(self) -> int:
        return NUM_EVENTS

    def num_samples(self) -> int:
        return int(self.chunks.shape[0])

    def num_batches(self) -> int:
        return -(-self.num_samples() // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        n = self.num_samples()
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        for start in range(0, n, bs):
            idx = order[start : start + bs]
            n_valid = len(idx)
            if n_valid < bs:
                # wrap-pad to the static batch size (NDArrayIter 'pad');
                # tile the pool — a corpus smaller than bs - n_valid must
                # still fill the batch (static shapes are a hard contract:
                # jit recompiles and mesh data-axis sharding both break on
                # a short batch).
                pad = bs - n_valid
                fill = np.tile(order, -(-pad // n))[:pad]
                idx = np.concatenate([idx, fill])
            if self.device_layout:
                yield RawBatch(
                    chunks=self.chunks[idx],
                    classes=self.classes[idx],
                    n_valid=n_valid,
                )
            else:
                yield Batch(
                    tokens=self.tokens[idx],
                    seq_lens=self.seq_lens[idx],
                    classes=self.classes[idx],
                    labels=self.labels[idx],
                    n_valid=n_valid,
                )


def load_dataset(
    loader_train,
    batch_size: int,
    split_percentage: Optional[float] = None,
    loader_val=None,
    device_layout: bool = False,
) -> Tuple[MelodyDataset, Optional[MelodyDataset]]:
    """Train/validation split logic (reference: data.py:201-223)."""

    def make(melodies, max_len):
        return MelodyDataset(batch_size, max_len, melodies,
                             device_layout=device_layout)

    if loader_val is not None:
        train = make(loader_train.melodies, loader_train.max_sequence_length)
        val = make(loader_val.melodies, loader_val.max_sequence_length)
        return train, val

    if split_percentage is None or split_percentage <= 0.0:
        return (
            make(loader_train.melodies, loader_train.max_sequence_length),
            None,
        )

    assert 0.0 < split_percentage < 1.0

    train_split: Dict[str, List[Melody]] = {}
    valid_split: Dict[str, List[Melody]] = {}
    for c, m in loader_train.melodies.items():
        n_validation = int(split_percentage * len(m))
        valid_split[c] = m[:n_validation]
        train_split[c] = m[n_validation:]
    return (
        make(train_split, loader_train.max_sequence_length),
        make(valid_split, loader_train.max_sequence_length),
    )
