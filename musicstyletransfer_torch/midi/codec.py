"""MIDI <-> event-token codec (tokenizer / detokenizer).

The PyTorch port's own copy of ``musicstyletransfer_tpu/midi/codec.py`` (the port imports
nothing of the JAX package); the two stay in step, and
``tests/test_torch_host_layers.py`` holds them to the same results.

Replaces the reference's ``EventBasedMIDIReader`` / ``MelodyWriter`` /
``Melody`` object model (reference: MIDIUtil/midi_io.py:31-132,
MIDIUtil/Melody.py:1-127). Instead of lists of Event objects, a melody here
is a numpy ``int32`` array of token ids plus (bpm, resolution) metadata —
the array-first representation feeds the device-side tensorizer directly.

Tokenization is **bit-identical** to the reference, including its quirks
(SURVEY.md §8.1):

- event classification is purely by velocity: velocity > 0 emits a note-ON
  token and velocity == 0 a note-OFF token, regardless of whether the SMF
  status byte was note-on or note-off (reference: midi_io.py:85-89);
- time gaps are emitted via ``while delta_t > 0: emit(delta_t % MAX_TICKS);
  delta_t -= MAX_TICKS`` (reference: midi_io.py:81-83), which *drops* ticks
  for gaps > 1000 and emits zero-shift tokens for exact multiples of 1000;
- only note events advance ``prev_t``, so gaps spanned purely by other
  events accumulate into the next note's delta;
- tracks with fewer than 10 tokens are discarded with a warning
  (reference: midi_io.py:60-63) and a file must yield >= 1 melody
  (reference: midi_io.py:67);
- the BPM is taken from the first SetTempo event anywhere in the file, in
  track order, else DEFAULT_BPM (reference: midi_io.py:16-25).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence

import numpy as np

from . import smf
from .vocab import (
    DEFAULT_BPM,
    DEFAULT_RESOLUTION,
    FEATURE_OFFSET,
    MAX_TICKS,
    is_note_off,
    is_note_on,
    is_timeshift,
    note_off_id,
    note_on_id,
    timeshift_id,
    token_pitch,
    token_tick_delay,
)


@dataclasses.dataclass
class Melody:
    """A tokenized single-track melody.

    ``tokens`` are vocabulary ids (see ``vocab``); ``bpm``/``resolution``
    carry through to the MIDI writer (reference: Melody.py:7-19).
    """

    tokens: np.ndarray
    bpm: float = DEFAULT_BPM
    resolution: int = DEFAULT_RESOLUTION
    description: str = ""

    def __post_init__(self) -> None:
        self.tokens = np.asarray(self.tokens, dtype=np.int32)

    def __len__(self) -> int:
        return int(self.tokens.shape[0])


def melody_from_ids(ids: Iterable[int], bpm: float = DEFAULT_BPM,
                    resolution: int = DEFAULT_RESOLUTION) -> Melody:
    """Build a Melody from raw ids, dropping specials (reference: Melody.py:87-90)."""
    arr = np.asarray(list(ids), dtype=np.int32)
    return Melody(tokens=arr[arr >= FEATURE_OFFSET], bpm=bpm, resolution=resolution)


def _extract_bpm(mf: smf.MidiFile) -> float:
    """First SetTempo's BPM in track order, else default (reference: midi_io.py:16-25)."""
    for track in mf.tracks:
        for ev in track:
            if isinstance(ev, smf.SetTempo):
                return ev.bpm
    return float(DEFAULT_BPM)


def tokenize_track(track: Sequence[smf.Event]) -> np.ndarray:
    """Token stream of one SMF track (reference: midi_io.py:70-93, bit-identical)."""
    tokens: List[int] = []
    prev_t = 0
    cur_t = 0
    for ev in track:
        cur_t += ev.tick
        if isinstance(ev, (smf.NoteOn, smf.NoteOff)):
            delta_t = cur_t - prev_t
            # Quirky reference arithmetic, kept verbatim (SURVEY.md §8.1):
            # emits delta % 1000 per iteration while subtracting 1000.
            while delta_t > 0:
                tokens.append(timeshift_id(delta_t % MAX_TICKS))
                delta_t -= MAX_TICKS
            if ev.velocity > 0:
                tokens.append(note_on_id(ev.pitch))
            elif ev.velocity == 0:
                tokens.append(note_off_id(ev.pitch))
            prev_t = cur_t
    return np.asarray(tokens, dtype=np.int32)


def melodies_from_tracks(
    file_name: str, token_tracks, bpm: float, resolution: int,
    min_tokens: int,
) -> List[Melody]:
    """Per-file track filter shared by the Python and native readers:
    short tracks are discarded with the reference's warning
    (midi_io.py:60-63) and an empty result asserts (midi_io.py:67).
    ONE implementation on purpose — the native reader's bit-identical
    behavior is a pinned invariant."""
    result: List[Melody] = []
    for tokens in token_tracks:
        if len(tokens) < min_tokens:
            print(
                f"Warning: {file_name} contains melodies of length "
                f"{len(tokens)} < {min_tokens}. Discarding"
            )
            continue
        result.append(Melody(tokens=tokens, bpm=bpm, resolution=resolution))
    assert len(result) > 0, f"no usable tracks in {file_name}"
    return result


class EventBasedMIDIReader:
    """MIDI file -> list of tokenized Melody, one per kept track.

    Reference: MIDIUtil/midi_io.py:31-67 (EventBasedMIDIReader.read_file).
    """

    MIN_TRACK_TOKENS = 10

    def read_file(self, file_name: str) -> List[Melody]:
        mf = smf.read_midifile(file_name)
        bpm = _extract_bpm(mf)
        return melodies_from_tracks(
            file_name, [tokenize_track(t) for t in mf.tracks], bpm,
            mf.resolution, self.MIN_TRACK_TOKENS,
        )


class MelodyWriter:
    """Tokenized melody -> single-track SMF file (reference: midi_io.py:96-132).

    Time-shift tokens accumulate into the next note event's delta tick;
    note-on velocity is hardcoded to 127 (reference: Melody.py:56-58) and
    note-off velocity to python-midi's default 64.
    """

    def write_to_file(self, file_name: str, melody: Melody) -> None:
        smf.write_midifile(file_name, self.to_midifile(melody))

    def to_midifile(self, melody: Melody) -> smf.MidiFile:
        track: List[smf.Event] = [smf.SetTempo.from_bpm(melody.bpm, tick=0)]
        tick_delay = 0
        for token in np.asarray(melody.tokens).tolist():
            if is_timeshift(token):
                tick_delay += token_tick_delay(token)
            elif is_note_on(token):
                track.append(
                    smf.NoteOn(tick=int(tick_delay), pitch=token_pitch(token),
                               velocity=127)
                )
                tick_delay = 0
            elif is_note_off(token):
                track.append(
                    smf.NoteOff(tick=int(tick_delay), pitch=token_pitch(token),
                                velocity=64)
                )
                tick_delay = 0
            # Specials (PAD/SOS/EOS) are silently skipped by the id filter in
            # melody_from_ids; raw specials reaching here are ignored too.
        track.append(smf.EndOfTrack(tick=1))
        return smf.MidiFile(format=1, resolution=melody.resolution, tracks=[track])
