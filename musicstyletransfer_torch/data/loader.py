"""Corpus loader: class-per-subdirectory MIDI corpus -> tokenized melodies.

The PyTorch port's own copy of ``musicstyletransfer_tpu/data/loader.py``:
by default it reads through the C++ tokenizer (``midi/native.py``, built
into ``build/native/`` at first use), and with the Python codec where that
cannot be built (no compiler) or ``use_native=False``. Both readers give
identical tokens (``tests/test_torch_native.py``).

Reference: VarAutoEncoder/data.py:14-39 (Loader). Immediate subdirectories of
``path`` (sorted by name) are the style classes; each class keeps only the
first track of every ``*.mid`` file (reference: data.py:35).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

from ..midi.codec import EventBasedMIDIReader, Melody


def _make_reader(use_native: bool):
    """The C++ tokenizer where asked for and buildable, else the Python codec
    (the JAX package's ``_make_reader``, which falls back silently; this one
    says so)."""
    if use_native:
        try:
            from ..midi.native import NativeMIDIReader

            return NativeMIDIReader()
        except (RuntimeError, OSError) as exc:
            print(f"{exc}; reading with the Python codec")
    return EventBasedMIDIReader()


class Loader:
    def __init__(self, path: str, max_sequence_length: int,
                 slices_per_quarter_note: float = 4,
                 use_native: bool = True):
        self.path = path
        self.max_sequence_length = max_sequence_length
        # Vestigial in the reference's event reader too (midi_io.py:31-33);
        # kept for CLI surface parity.
        self.slices_per_quarter_note = slices_per_quarter_note
        self.midi_reader = _make_reader(use_native)
        self.melodies = self.read_melodies()

    def read_melodies(self) -> Dict[str, List[Melody]]:
        print(f"Reading from {self.path}")
        if not os.path.isdir(self.path):
            raise FileNotFoundError(
                f"corpus directory {self.path!r} does not exist (expected "
                "one subdirectory per style class containing .mid files)"
            )
        melodies: Dict[str, List[Melody]] = {}
        directories = next(os.walk(self.path))[1]
        for directory in sorted(directories):
            # Sorted: glob order is filesystem-dependent, and the melody
            # ordering decides the validation split and the batch stream.
            files = sorted(glob.glob(os.path.join(self.path, directory, "*.mid")))
            if hasattr(self.midi_reader, "scan_files") and (os.cpu_count() or 1) > 1:
                # the C++ scanner's threads, one call a class directory (on one
                # core its merge copy makes the per-file path faster)
                melodies[directory] = [m[0] for m in self.midi_reader.scan_files(files)]
            else:
                melodies[directory] = [
                    self.midi_reader.read_file(fname)[0] for fname in files
                ]
            print(f"Read {len(files)} files from {directory}")
        return melodies
