"""ctypes binding of the request tokenizer (``csrc/request_tokenizer.cpp``).

``first_track_tokens`` is one C call a file: the first track with a note
event, tokenized and cut to ``max_len``, token for token what the service's
Python route (``smf.parse_midifile``, then ``codec.tokenize_track``) gives.
Where that route raises, or the C reader cannot follow it exactly (the
source's header lists the cases), it returns None and the caller runs the
route. The tokens are written into an int32 array kept per thread and
grown to ``max_len``, then copied out: a call allocates only the array it
returns, which is the caller's to keep.

Built at first use as ``native.py`` builds the tokenizer: with ``$CXX``
(else ``g++``) and the same flags into ``build/native/``, the file name
carrying the hash of the source and the flags. Where it does not build,
``load_library`` returns None (the reason in ``LIBRARY.error``).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from . import native

SOURCE = Path(__file__).resolve().parent / "csrc" / "request_tokenizer.cpp"
STEM = "libmst_request_tokenizer"
_scratch = threading.local()


def _bind(lib: ctypes.CDLL) -> None:
    lib.mst_request_tokens.restype = ctypes.c_int32
    lib.mst_request_tokens.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
                                       ctypes.c_void_p]


LIBRARY = native.PortLibrary(SOURCE, STEM, _bind)


def load_library() -> Optional[ctypes.CDLL]:
    """The tokenizer's library (built first if needed); None if unavailable."""
    return LIBRARY.load()


def first_track_tokens(midi_bytes: bytes, max_len: int) -> Optional[np.ndarray]:
    """A fresh int32 array of the request's tokens, or None where the Python
    route has to run: the library does not load, ``midi_bytes`` is not
    ``bytes``, ``max_len`` is negative, or the C reader declines the
    file."""
    lib = load_library()
    if lib is None or type(midi_bytes) is not bytes or max_len < 0:
        return None
    tokens = getattr(_scratch, "tokens", None)
    if tokens is None or len(tokens) < max_len:
        tokens = _scratch.tokens = np.empty(max(max_len, 4096), np.int32)
        _scratch.address = tokens.ctypes.data
    n = lib.mst_request_tokens(midi_bytes, len(midi_bytes), max_len, _scratch.address)
    return tokens[:n].copy() if n >= 0 else None
