"""Host->device input prefetching: batch preparation and transfer overlap
the device's compute (counterpart of ``musicstyletransfer_tpu/data/
prefetch.py:24-141``).

A producer thread takes the next batches from the dataset, stages each in
pinned host tensors and copies them to the card on a side stream, behind an
event; the consumer makes its stream wait for that event before it uses the
batch. ``size`` batches are staged ahead. An error in the producer is
raised in the consumer, and a consumer that stops early stops the producer.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from .dataset import Batch

_SENTINEL = object()


@dataclasses.dataclass
class DeviceBatch:
    """A host ``Batch`` and its (tokens, seq_lens, classes, labels) as int64
    tensors on the device."""

    batch: Batch
    tensors: Tuple[torch.Tensor, ...]


def _stage(batch: Batch, device: torch.device, stream) -> Tuple[DeviceBatch, object]:
    arrays = (batch.tokens, batch.seq_lens, batch.classes, batch.labels)
    host = [torch.from_numpy(np.asarray(a, dtype=np.int64)) for a in arrays]
    if stream is None:
        return DeviceBatch(batch, tuple(host)), None
    with torch.cuda.stream(stream):
        tensors = tuple(h.pin_memory().to(device, non_blocking=True) for h in host)
        event = torch.cuda.Event()
        event.record(stream)
    return DeviceBatch(batch, tensors), event


def prefetch_batches(batches: Iterable[Batch], size: int = 2,
                     device: Optional[torch.device] = None) -> Iterator[DeviceBatch]:
    """Iterate ``batches`` as ``DeviceBatch``es on ``device`` (the CPU by
    default), ``size`` of them staged ahead by a producer thread."""
    device = torch.device(device or "cpu")
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    err: list = []
    # The consumer can abandon this generator mid-epoch (early stop, a
    # signal): the producer polls a stop event instead of blocking on a full
    # queue, and the generator's finally block sets it and drains the queue.
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            for batch in batches:
                if stop.is_set():
                    return
                with tracing.span("prefetch.stage"):
                    staged = _stage(batch, device, stream)
                if not put(staged):
                    return
        except BaseException as exc:  # raised again in the consumer
            err.append(exc)
        finally:
            put(_SENTINEL)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            with tracing.span("prefetch.wait"):
                item = q.get()
                if item is _SENTINEL:
                    break
                staged, event = item
                if event is not None:
                    current = torch.cuda.current_stream(device)
                    current.wait_event(event)
                    for t in staged.tensors:  # not reused while the consumer's work is queued
                        t.record_stream(current)
            yield staged
        if err:
            raise err[0]
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=10)


class PrefetchingDataset:
    """A dataset whose every epoch is iterated through ``prefetch_batches``;
    everything else is the wrapped dataset's."""

    def __init__(self, dataset, size: int = 2, device: Optional[torch.device] = None):
        self._dataset = dataset
        self._size = size
        self._device = device

    def num_classes(self) -> int:
        return self._dataset.num_classes()

    def num_tokens(self) -> int:
        return self._dataset.num_tokens()

    def __getattr__(self, name):
        return getattr(self._dataset, name)

    def __iter__(self):
        return prefetch_batches(iter(self._dataset), self._size, self._device)
