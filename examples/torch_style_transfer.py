"""Minimal end-to-end style transfer with the PyTorch port's library API.

Loads the shipped pretrained model (its export ``models/guitar_bass/torch/``),
tokenizes one MIDI file, transfers it into every style class (one encode
and one K1 launch on the card) and writes the results as MIDI.

    python examples/torch_style_transfer.py [input.mid] [model_dir] [out_dir] [--cpu]

Defaults: the first bundled corpus file, models/guitar_bass, /tmp/mst-example.
Runs on the CUDA card, and raises where there is none, unless ``--cpu``.
"""

import argparse
import glob
import os
import sys

# Runnable from a plain checkout (no pip install): the repo root is the
# example's parent directory.
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from musicstyletransfer_torch.inference.decode import style_transfer_all_classes  # noqa: E402
from musicstyletransfer_torch.inference.sampler import load_inference_model  # noqa: E402
from musicstyletransfer_torch.midi.codec import (EventBasedMIDIReader,  # noqa: E402
                                                 MelodyWriter, melody_from_ids)
from musicstyletransfer_torch.midi.vocab import PAD_ID, SOS_ID  # noqa: E402
from musicstyletransfer_torch.utils import resolve_device  # noqa: E402


def main(argv=None) -> None:
    corpus = sorted(glob.glob(os.path.join(REPO, "work/data/guitar_bass/*/*.mid")))
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input", nargs="?", default=corpus[0] if corpus else None)
    parser.add_argument("model_dir", nargs="?", default=os.path.join(REPO, "models", "guitar_bass"))
    parser.add_argument("out_dir", nargs="?", default="/tmp/mst-example")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)
    if args.input is None:
        raise SystemExit("No bundled corpus found: pass an input MIDI file:\n"
                         "  python examples/torch_style_transfer.py input.mid "
                         "[model_dir] [out_dir]")
    os.makedirs(args.out_dir, exist_ok=True)
    device = resolve_device(cpu=args.cpu)

    # 1. host: MIDI bytes -> event tokens
    melody = EventBasedMIDIReader().read_file(args.input)[0]
    L = 64
    chunk = melody.tokens[:L]
    tokens = np.full((1, L + 1), PAD_ID, np.int64)
    tokens[0, 0] = SOS_ID
    tokens[0, 1:len(chunk) + 1] = chunk

    # 2. device: encode + decode into every class, one call
    model = load_inference_model(args.model_dir, checkpoint=-1, device=device)
    num_classes = model.config.encoder_config.num_classes
    seqs, scores = style_transfer_all_classes(
        model, torch.as_tensor(tokens, device=device),
        torch.as_tensor([len(chunk) + 1], device=device),
        max_len=2 * (L + 1), num_classes=num_classes, seed=0, temperature=1.0, top_p=0.95)

    # 3. host: tokens -> MIDI files
    writer = MelodyWriter()
    base = os.path.splitext(os.path.basename(args.input))[0]
    seqs, scores = seqs.cpu().numpy(), scores.cpu().numpy()
    for c in range(num_classes):
        out = melody_from_ids(seqs[c, 0], bpm=melody.bpm, resolution=melody.resolution)
        path = os.path.join(args.out_dir, f"{base}.class-{c}.mid")
        writer.write_to_file(path, out)
        print(f"class {c}: {len(out)} events, score {float(scores[c, 0]):.2f} -> {path}")


if __name__ == "__main__":
    main()
