"""Tokenize -> detokenize round trip of one MIDI file (the port's copy of
``musicstyletransfer_tpu/midi/roundtrip.py``): reads a MIDI file, writes its
first melody back as ``<basename>_rewrite.mid`` and prints the melody's
length.

Usage: ``python -m musicstyletransfer_torch.midi.roundtrip file.mid [out.mid]``

The rewrite lands in the current directory by default (not next to the
input, which may live in a read-only corpus); pass an output path to choose.
"""

from __future__ import annotations

import argparse
import os

from .codec import EventBasedMIDIReader, MelodyWriter


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("file")
    parser.add_argument("out", nargs="?", default=None,
                        help="output path (default: <basename>_rewrite.mid "
                             "in the current directory)")
    args = parser.parse_args(argv)

    melodies = EventBasedMIDIReader().read_file(args.file)
    out = args.out or os.path.basename(args.file) + "_rewrite.mid"
    MelodyWriter().write_to_file(out, melodies[0])
    print(f"Melody length: {len(melodies[0])}")
    print(f"Rewrote to {out}")


if __name__ == "__main__":
    main()
