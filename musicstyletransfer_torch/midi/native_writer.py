"""ctypes binding of the batched MIDI writer (``csrc/midi_writer.cpp``).

One call writes a single-track SMF file for every token row it is given,
each byte for byte what ``smf.dump_midifile(MelodyWriter().to_midifile(
melody_from_ids(row)))`` gives, into one buffer with an offset table; one
more gives every row's event ids, ``melody_from_ids(row).tokens``. No event
objects and no Python loop over tokens. The service's ``results_of``
detokenizes and writes its micro-batches through it.

Rows are int32 ids (K1's rows and ``Melody.tokens`` are); wider rows are
cast as ``melody_from_ids`` casts them. Built at first use as ``native.py``
builds the tokenizer: with ``$CXX`` (else ``g++``) and the same flags into
``build/native/``, the file name carrying the hash of the source and the
flags. Where no compiler builds it, ``load_library`` returns None (the
reason in ``LIBRARY.error``) and the callers write with ``MelodyWriter``.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import native, smf
from .vocab import DEFAULT_BPM, DEFAULT_RESOLUTION

SOURCE = Path(__file__).resolve().parent / "csrc" / "midi_writer.cpp"
STEM = "libmst_midi_writer"

_scratch = threading.local()


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.mst_midi_capacity.restype = i64
    lib.mst_midi_capacity.argtypes = [i64, i64]
    lib.mst_event_ids.restype = i64
    lib.mst_event_ids.argtypes = [ptr, i64, ptr, i32, ptr, ptr]
    lib.mst_write_midi_rows.restype = i64
    lib.mst_write_midi_rows.argtypes = [ptr, i64, ptr, i32, i32, i32, ptr, i64, ptr]


LIBRARY = native.PortLibrary(SOURCE, STEM, _bind)


def load_library() -> Optional[ctypes.CDLL]:
    """The writer's library (built first if needed); None if unavailable."""
    return LIBRARY.load()


def _library() -> ctypes.CDLL:
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native MIDI writer unavailable ({LIBRARY.error})")
    return lib


def _checked(tokens: np.ndarray, offsets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The arrays as the library reads them: contiguous int32 ids and int64
    offsets (the library refuses offsets that fall or lie outside the
    ids)."""
    if len(offsets) < 1:
        raise ValueError("row offsets need at least one entry")
    return (np.ascontiguousarray(tokens, dtype=np.int32),
            np.ascontiguousarray(offsets, dtype=np.int64))


def _refused(rc: int) -> Exception:
    if rc == -2:
        return ValueError("row offsets must not fall and must lie within the tokens")
    return RuntimeError("native MIDI writer: output capacity exceeded")


def _scratch_array(name: str, size: int, dtype) -> np.ndarray:
    """This thread's scratch array ``name`` of at least ``size`` entries,
    grown by doubling. The calls work in it and copy out only what they
    return: a call's temporaries then touch no new memory, which matters
    where the caller keeps every result and the heap grows all the while."""
    buf = getattr(_scratch, name, None)
    if buf is None or len(buf) < size:
        buf = np.empty(max(size, 2 * (0 if buf is None else len(buf))), dtype)
        setattr(_scratch, name, buf)
    return buf


def pack(rows: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Rows of any lengths as one int32 id array (cast as ``melody_from_ids``
    casts) and the [rows + 1] int64 offsets of their starts and end. The ids
    are a view of this thread's scratch, good until the thread packs again."""
    n = len(rows)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, rows), np.int64, n), out=offsets[1:])
    total = int(offsets[-1])
    tokens = _scratch_array("tokens", total, np.int32)[:total]
    if n:
        np.concatenate(rows, out=tokens, casting="unsafe")
    return tokens, offsets


def event_ids(tokens: np.ndarray, offsets: np.ndarray) -> List[np.ndarray]:
    """Each row's ids that are no special, ``melody_from_ids(row).tokens``,
    of ``pack``'s ``tokens`` and ``offsets`` (views of one int32 array)."""
    tokens, offsets = _checked(tokens, offsets)
    n = len(offsets) - 1
    ids = _scratch_array("ids", len(tokens), np.int32)
    ends = np.empty(n + 1, dtype=np.int64)
    rc = _library().mst_event_ids(tokens.ctypes.data, len(tokens), offsets.ctypes.data, n,
                                  ids.ctypes.data, ends.ctypes.data)
    if rc < 0:
        raise _refused(rc)
    kept = ids[:rc].copy()
    bounds = ends.tolist()
    return [kept[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def write_midi(tokens: np.ndarray, offsets: np.ndarray, resolution: int = DEFAULT_RESOLUTION,
               bpm: float = DEFAULT_BPM) -> List[bytes]:
    """The SMF file of each row of ``pack``'s ``tokens`` and ``offsets``, as
    ``MelodyWriter`` writes the melody of the row's ids at ``bpm`` and
    ``resolution``."""
    lib = _library()
    tokens, offsets = _checked(tokens, offsets)
    n = len(offsets) - 1
    # The tempo's float-to-int rounding stays Python's.
    mpqn = smf.SetTempo.from_bpm(bpm).mpqn
    cap = lib.mst_midi_capacity(n, int(offsets[-1] - offsets[0]))
    out = _scratch_array("midi", cap, np.uint8)
    file_offsets = np.empty(n + 1, dtype=np.int64)
    size = lib.mst_write_midi_rows(tokens.ctypes.data, len(tokens), offsets.ctypes.data, n,
                                   resolution, mpqn, out.ctypes.data, len(out),
                                   file_offsets.ctypes.data)
    if size < 0:
        raise _refused(size)
    view = memoryview(out)
    bounds = file_offsets.tolist()
    return [bytes(view[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
