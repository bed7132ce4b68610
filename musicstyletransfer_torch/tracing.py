"""Spans at the port's layer boundaries, on the profiler's clock.

``span(name)`` is a context manager around a stretch of host code.
It records only while a ``torch.profiler`` trace runs in the process (a
benchmark's traced window, the trainer's ``profile_dir``): the switch is
``torch.autograd.profiler._is_profiler_enabled``, which is set for the whole
process, where ``torch.autograd._profiler_enabled()`` answers for the calling
thread only (it reads False on the prefetch thread while the main thread
profiles). With no trace running a span is one shared null context: one
attribute read, nothing allocated, nothing recorded.

A recorded ``Span`` holds its name and its start and end in
``time.time_ns()``, the clock the profiler's events are on; a span inside
another lies within it. Each span also opens a profiler range of its name
(``_RecordFunctionFast``), so it shows in exported traces as a host
operation. ``record_function`` is not used: under a CUDA trace it also puts a
user annotation on the device's timeline, which a reader of device events
takes for device work, and it costs 30-45 us a span on the H100's host. The
newest ``MAX_SPANS`` spans are kept in memory; ``spans`` reads them and
``clear`` drops them. Nothing is written to disk.

The spans the port records:

- convert: ``service.tokenize`` a request file (``tokens_from_midi``);
  ``service.dispatch`` (``service.batch``, ``decode.encode``,
  ``decode.k1``) and ``service.finish`` (``service.copy_back``,
  ``service.detokenize``, ``service.midi_write``), a micro-batch each
  (the streaming engine records the last two, a request each);
- training: ``train.dispatch`` a group, and inside ``GraphedGroups.run``
  ``graph.copy_in``, ``graph.capture`` (a key's first use), ``graph.replay``,
  ``graph.after``;
- the prefetching feed: ``prefetch.stage`` a batch on the producer thread,
  ``prefetch.wait`` a batch on the consumer;
- the experts (``models/moe.py``): ``moe.route``, ``moe.permute``,
  ``moe.experts``, ``moe.combine``, a layer each (in an eager step, or
  once as a graph captures its step: a replay runs no host code).
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import List, NamedTuple, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 17

_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


_DONE: collections.deque = collections.deque(maxlen=MAX_SPANS)  # the newest finished spans


def span(name: str):
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Open(name)


def spans(start_ns: int = 0, end_ns: Optional[int] = None) -> List[Span]:
    """The kept spans that started in [start_ns, end_ns], oldest first."""
    return [s for s in tuple(_DONE)
            if start_ns <= s.start_ns and (end_ns is None or s.start_ns <= end_ns)]


def clear() -> None:
    _DONE.clear()


class _Open:
    """One recorded span while it is open."""

    __slots__ = ("name", "start_ns", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.start_ns = time.time_ns()
        self.range = _RecordFunctionFast(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        _DONE.append(Span(self.name, self.start_ns, time.time_ns()))
        return False
