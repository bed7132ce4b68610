"""Corpus loader: class-per-subdirectory MIDI corpus -> tokenized melodies.

The PyTorch port's own copy of ``musicstyletransfer_tpu/data/loader.py``
with the pure-Python reader only: the JAX package's C++ tokenizer route
(``midi/native.py`` and ``native/``) is not carried over, and asking for it
raises. Both readers give identical tokens (pinned there by the JAX
package's equivalence sweep, here by ``tests/test_torch_host_layers.py``).

Reference: VarAutoEncoder/data.py:14-39 (Loader). Immediate subdirectories of
``path`` (sorted by name) are the style classes; each class keeps only the
first track of every ``*.mid`` file (reference: data.py:35).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

from ..midi.codec import EventBasedMIDIReader, Melody


class Loader:
    def __init__(self, path: str, max_sequence_length: int,
                 slices_per_quarter_note: float = 4,
                 use_native: bool = False):
        if use_native:
            raise NotImplementedError(
                "the C++ tokenizer (NativeMIDIReader) is not part of the "
                "PyTorch port; use_native=False reads with the Python codec, "
                "which gives the same tokens")
        self.path = path
        self.max_sequence_length = max_sequence_length
        # Vestigial in the reference's event reader too (midi_io.py:31-33);
        # kept for CLI surface parity.
        self.slices_per_quarter_note = slices_per_quarter_note
        self.midi_reader = EventBasedMIDIReader()
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
            melodies[directory] = [
                self.midi_reader.read_file(fname)[0] for fname in files
            ]
            print(f"Read {len(files)} files from {directory}")
        return melodies
