"""Write each track of each ``.mid`` in a directory as its own single-track
MIDI file, ``<name>_<track>.mid`` (the port's copy of
``musicstyletransfer_tpu/midi/splitter.py``, the working form of the
reference's MIDISplitter; it produced the ``work/data/splits/`` layout).

Usage: ``python -m musicstyletransfer_torch.midi.splitter <in_dir> <out_dir>``
"""

from __future__ import annotations

import argparse
import glob
import os

from .codec import EventBasedMIDIReader, MelodyWriter
from .smf import SmfError


def split_directory(input_dir: str, output_dir: str) -> int:
    """Split every ``.mid`` of ``input_dir`` into ``output_dir``; returns the
    number of files written. A file that does not parse is reported and
    skipped."""
    os.makedirs(output_dir, exist_ok=True)
    reader = EventBasedMIDIReader()
    writer = MelodyWriter()
    n_written = 0
    for fname in sorted(glob.glob(os.path.join(input_dir, "*.mid"))):
        base = os.path.splitext(os.path.basename(fname))[0].replace(" ", "_")
        try:
            melodies = reader.read_file(fname)
        except (OSError, SmfError) as exc:
            print(f"Skipping {fname}: {exc}")
            continue
        for idx, melody in enumerate(melodies):
            writer.write_to_file(os.path.join(output_dir, f"{base}_{idx}.mid"), melody)
            n_written += 1
    return n_written


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input_dir")
    parser.add_argument("output_dir")
    args = parser.parse_args(argv)
    n = split_directory(args.input_dir, args.output_dir)
    print(f"Wrote {n} split tracks to {args.output_dir}")


if __name__ == "__main__":
    main()
