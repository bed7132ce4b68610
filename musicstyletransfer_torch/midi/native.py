"""ctypes binding of the C++ MIDI tokenizer (``native/midi_tokenizer.cpp``):
the port's own copy of ``musicstyletransfer_tpu/midi/native.py``.

A twin of ``codec.EventBasedMIDIReader`` with the same token streams, one
pass over the file bytes with no Python object graph; the corpus
``Loader`` reads with it by default.

Built at first use with the C++ compiler (``$CXX``, else ``g++``) and the
flags of ``native/Makefile`` into ``build/native/`` under the repository
root, the file name carrying the hash of the source and the flags, so an
edited source is rebuilt and ``native/`` is never written. Where no
compiler builds it, ``load_library`` returns None and the Loader reads with
the Python codec, as the JAX package's does. ``PortLibrary`` builds and
loads the port's own sources the same way: the batched MIDI writer
(``native_writer.py``) and the request tokenizer (``native_request.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..utils import REPO_ROOT
from .codec import Melody, melodies_from_tracks as _to_melodies
from .vocab import DEFAULT_BPM

SOURCE = REPO_ROOT / "native" / "midi_tokenizer.cpp"
BUILD_DIR = REPO_ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-pthread", "-shared")

_ERRORS = {
    -1: "not an SMF file",
    -2: "truncated file",
    -3: "unsupported SMF feature (SMPTE division)",
    -4: "buffer capacity exceeded",
    -5: "bad event byte",
    -6: "corpus exceeds the int32 token arena (2^31 tokens); "
        "split the scan into smaller path batches",
}
_ERR_CAPACITY = -4  # MST_ERR_CAPACITY: the caller retries with the reported sizes

_lib: Optional[ctypes.CDLL] = None
_lib_load_failed = False
build_error = ""  # why the last build failed, for the fallback's message


def library_path(source: Path = SOURCE, stem: str = "libmst_native") -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"


def compile_library(source: Path, stem: str) -> Tuple[Optional[Path], str]:
    """Compile ``source`` into ``BUILD_DIR`` unless a build of this exact
    source exists: (the library, "") or, where it cannot be built, (None,
    why)."""
    if not source.exists():
        return None, f"{source} is missing"
    out = library_path(source, stem)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (subprocess.SubprocessError, OSError) as exc:
        return None, f"{' '.join(cmd)}: {exc}"
    if proc.returncode != 0:
        return None, f"{' '.join(cmd)} exited {proc.returncode}: {proc.stderr[-2000:]}"
    os.replace(tmp, out)
    return out, ""


class PortLibrary:
    """One of the port's own sources (``midi/csrc/``), built with
    ``compile_library`` and loaded at its first ``load``, once for all
    threads; ``bind`` sets its functions' argument and result types.
    ``load`` gives the library, or None with the reason in ``error``."""

    def __init__(self, source: Path, stem: str, bind: Callable[[ctypes.CDLL], None]):
        self.source, self.stem, self._bind = source, stem, bind
        self.lib: Optional[ctypes.CDLL] = None
        self.failed = False
        self.error = ""
        self._lock = threading.Lock()

    def load(self) -> Optional[ctypes.CDLL]:
        if self.lib is not None or self.failed:
            return self.lib
        with self._lock:
            if self.lib is None and not self.failed:
                path, self.error = compile_library(self.source, self.stem)
                try:
                    lib = ctypes.CDLL(str(path)) if path is not None else None
                except OSError as exc:
                    lib, self.error = None, f"loading {path}: {exc}"
                if lib is None:
                    self.failed = True
                else:
                    self._bind(lib)
                    self.lib = lib
        return self.lib


def build() -> Optional[Path]:
    """Compile the tokenizer unless a build of this exact source exists;
    None (reason in ``build_error``) where it cannot be built."""
    global build_error
    out, error = compile_library(SOURCE, "libmst_native")
    if out is None:
        build_error = error
    return out


def load_library() -> Optional[ctypes.CDLL]:
    """The tokenizer's library (built first if needed); None if unavailable."""
    global _lib, _lib_load_failed, build_error
    if _lib is not None:
        return _lib
    if _lib_load_failed:
        return None
    path = build()
    if path is None:
        _lib_load_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as exc:
        build_error = f"loading {path}: {exc}"
        _lib_load_failed = True
        return None
    i32p, f64p, i64p = (ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
                        ctypes.POINTER(ctypes.c_int64))
    lib.mst_tokenize_buffer.restype = ctypes.c_int32
    lib.mst_tokenize_buffer.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32p, ctypes.c_int32,
                                        i32p, ctypes.c_int32, i32p, i32p, f64p]
    lib.mst_tokenize_files.restype = ctypes.c_int64
    lib.mst_tokenize_files.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
                                       ctypes.c_int32, i32p, ctypes.c_int64, i32p,
                                       ctypes.c_int64, i32p, i32p, i32p, f64p, i64p, i64p]
    _lib = lib
    return lib


def available() -> bool:
    return load_library() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeMIDIReader:
    """MIDI file -> tokenized melodies through the C++ tokenizer, with
    ``codec.EventBasedMIDIReader``'s surface and semantics (reference:
    midi_io.py:31-67): tracks of fewer than 10 tokens are dropped with a
    warning; at least one melody must remain."""

    MIN_TRACK_TOKENS = 10
    # The C++ scanner's per-file cap (scan_one): the threaded and per-file
    # paths must accept the same corpora.
    MAX_TRACKS = 4096

    def __init__(self) -> None:
        lib = load_library()
        if lib is None:
            raise RuntimeError(f"native tokenizer unavailable ({build_error}); "
                               "use codec.EventBasedMIDIReader")
        self._lib = lib

    def tokenize_bytes(self, buf: bytes):
        """-> (list of per-track int32 token arrays, bpm, resolution)."""
        cap = max(len(buf) * 2, 4096)  # tokens <= ~2 per event byte
        out = np.empty(cap, dtype=np.int32)
        offsets = np.empty(self.MAX_TRACKS + 1, dtype=np.int32)
        n_tracks = ctypes.c_int32(0)
        resolution = ctypes.c_int32(0)
        bpm = ctypes.c_double(DEFAULT_BPM)
        rc = self._lib.mst_tokenize_buffer(
            buf, len(buf), _ptr(out, ctypes.c_int32), cap, _ptr(offsets, ctypes.c_int32),
            self.MAX_TRACKS, ctypes.byref(n_tracks), ctypes.byref(resolution),
            ctypes.byref(bpm))
        if rc < 0:
            raise ValueError(f"native tokenizer: {_ERRORS.get(rc, rc)}")
        tracks = [out[offsets[t]:offsets[t + 1]].copy() for t in range(n_tracks.value)]
        return tracks, bpm.value, resolution.value

    def read_file(self, file_name: str) -> List[Melody]:
        with open(file_name, "rb") as fh:
            buf = fh.read()
        tracks, bpm, resolution = self.tokenize_bytes(buf)
        return _to_melodies(file_name, tracks, bpm, resolution, self.MIN_TRACK_TOKENS)

    def scan_files(self, paths: List[str],
                   n_threads: Optional[int] = None) -> List[List[Melody]]:
        """Tokenize many files in one call on the C++ scanner's threads (file
        reads and parsing both); one melody list per file, with
        ``read_file``'s semantics (a file the parser rejects raises
        ValueError naming it)."""
        if not paths:
            return []
        n = len(paths)
        if n_threads is None:
            n_threads = min(32, os.cpu_count() or 1)
        tokens_cap = sum(os.path.getsize(p) * 2 + 4096 for p in paths)
        track_cap = n * 64 + 4096  # ~64 tracks a file to start with
        c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        file_track_index = np.empty(n + 1, dtype=np.int32)
        file_rc = np.empty(n, dtype=np.int32)
        resolutions = np.empty(n, dtype=np.int32)
        bpms = np.empty(n, dtype=np.float64)
        # The C contract is retry-on-capacity: on MST_ERR_CAPACITY the scanner
        # reports the exact sizes it needs, so at most one retry with those.
        required_tokens = ctypes.c_int64(0)
        required_tracks = ctypes.c_int64(0)
        for _ in range(2):
            tokens = np.empty(tokens_cap, dtype=np.int32)
            track_starts = np.empty(track_cap, dtype=np.int32)
            total = self._lib.mst_tokenize_files(
                c_paths, n, n_threads, _ptr(tokens, ctypes.c_int32), tokens_cap,
                _ptr(track_starts, ctypes.c_int32), track_cap,
                _ptr(file_track_index, ctypes.c_int32), _ptr(file_rc, ctypes.c_int32),
                _ptr(resolutions, ctypes.c_int32), _ptr(bpms, ctypes.c_double),
                ctypes.byref(required_tokens), ctypes.byref(required_tracks))
            if total != _ERR_CAPACITY:
                break
            tokens_cap = max(required_tokens.value, 1)
            track_cap = max(required_tracks.value, 1)
        if total < 0:
            raise ValueError(f"native corpus scan: {_ERRORS.get(total, total)}")
        out: List[List[Melody]] = []
        for i, path in enumerate(paths):
            if file_rc[i] != 0:
                raise ValueError(f"{path}: {_ERRORS.get(int(file_rc[i]), int(file_rc[i]))}")
            lo, hi = int(file_track_index[i]), int(file_track_index[i + 1])
            bounds = list(track_starts[lo:hi + 1])
            tracks = [tokens[bounds[t]:bounds[t + 1]].copy() for t in range(hi - lo)]
            out.append(_to_melodies(path, tracks, float(bpms[i]), int(resolutions[i]),
                                    self.MIN_TRACK_TOKENS))
        return out
