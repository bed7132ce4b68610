"""Device resolution, the repository root and the piano roll (counterpart of
``musicstyletransfer_tpu/utils.py``)."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .midi.codec import Melody
from .midi.vocab import is_note_off, is_note_on, is_timeshift, token_pitch, token_tick_delay

REPO_ROOT = Path(__file__).resolve().parent.parent


def resolve_device(gpu: bool = False, cpu: bool = False) -> torch.device:
    """The entry points' device: CUDA by default and with ``--gpu``, raising
    when there is no card; the CPU only when ``--cpu`` asks for it. Nothing
    carries on on the CPU when the card is missing."""
    if gpu and cpu:
        raise ValueError("--gpu and --cpu exclude each other")
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on CUDA unless --cpu is given, but "
            "torch.cuda.is_available() is False"
        )
    return torch.device("cuda")


def melody_to_piano_roll(melody: Melody, ticks_per_column: int = 30,
                         max_columns: int = 2048) -> np.ndarray:
    """[128, T] binary piano roll of a tokenized melody (``utils.py:90-126``
    of the JAX package): a note-on starts a pitch, a note-off ends it, a
    time shift advances the clock. The tokenizer writes note-offs as
    note-on tokens, so a repeated note-on also ends the pitch's open note."""
    roll = np.zeros((128, max_columns), dtype=np.float32)
    active: Dict[int, int] = {}
    t = 0
    for token in np.asarray(melody.tokens).tolist():
        col = min(t // ticks_per_column, max_columns - 1)
        if is_timeshift(token):
            t += token_tick_delay(token)
        elif is_note_on(token) or is_note_off(token):
            pitch = token_pitch(token)
            start = active.pop(pitch, None)
            if start is not None:
                roll[pitch, start:col + 1] = 1.0
            elif is_note_on(token):
                active[pitch] = col
    last_col = min(t // ticks_per_column, max_columns - 1)
    for pitch, start in active.items():  # notes never turned off
        roll[pitch, start:last_col + 1] = 1.0
    used = int(np.max(np.nonzero(roll)[1])) + 1 if roll.any() else 1
    return roll[:, :used]


def visualize_melody(melody: Melody, path: Optional[str] = None) -> np.ndarray:
    """The piano roll, drawn with matplotlib (``Agg``) to ``path``, or shown
    without one; without matplotlib only the roll is returned, as in the
    JAX package (``utils.py:129-152``)."""
    roll = melody_to_piano_roll(melody)
    try:
        import matplotlib
    except ImportError:
        return roll
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 4))
    ax.imshow(roll[::-1], cmap="gray_r", aspect="auto", interpolation="nearest")
    ax.set_xlabel("time (30-tick bins)")
    ax.set_ylabel("MIDI pitch")
    if path:
        fig.savefig(path, bbox_inches="tight", dpi=120)
    else:
        plt.show()
    plt.close(fig)
    return roll
