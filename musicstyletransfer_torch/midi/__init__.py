"""MIDI <-> tokens: the port's copies of the JAX package's ``midi`` modules."""

from . import smf, vocab
from .codec import EventBasedMIDIReader, Melody, MelodyWriter, melody_from_ids, tokenize_track

__all__ = [
    "smf",
    "vocab",
    "EventBasedMIDIReader",
    "Melody",
    "MelodyWriter",
    "melody_from_ids",
    "tokenize_track",
]
