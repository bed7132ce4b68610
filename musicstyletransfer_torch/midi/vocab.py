"""Event vocabulary: the 293-token id space shared by tokenizer and model.

The PyTorch port's own copy of ``musicstyletransfer_tpu/midi/vocab.py`` (the port imports
nothing of the JAX package); the two stay in step, and
``tests/test_torch_host_layers.py`` holds them to the same results.

Mirrors the reference constants exactly (reference: MIDIUtil/defaults.py:44-58):

- specials: PAD=0, SOS=1, EOS=2
- note-on events:   ids [3, 130]    (128 MIDI pitches)
- note-off events:  ids [131, 258]  (128 MIDI pitches)
- time-shift events: ids [259, 292] (NUM_BINS=34 bins of 30 ticks over [0, 1000))
- NUM_EVENTS = 293

The import-time ``print(TIMESHIFT_EVENTS)`` side effect of the reference
(defaults.py:57) is intentionally NOT reproduced.
"""

from __future__ import annotations

DEFAULT_BPM = 120
DEFAULT_RESOLUTION = 220

MAX_TICKS = 1000
MIN_TICKS = 0
NUM_TICKS_IN_A_BIN = 30
# (1000 - 0) / 30 + 1 = 34 bins (reference: defaults.py:41)
NUM_BINS = int((MAX_TICKS - MIN_TICKS) / NUM_TICKS_IN_A_BIN) + 1

PAD_ID = 0
SOS_ID = 1
EOS_ID = 2
SPECIAL_TOKENS = (PAD_ID, SOS_ID, EOS_ID)
FEATURE_OFFSET = len(SPECIAL_TOKENS)

# Inclusive id ranges (reference: defaults.py:50-56).
NOTE_ON_EVENTS = (FEATURE_OFFSET + 0, FEATURE_OFFSET + 127)
NOTE_OFF_EVENTS = (NOTE_ON_EVENTS[1] + 1, NOTE_ON_EVENTS[1] + 128)
TIMESHIFT_EVENTS = (NOTE_OFF_EVENTS[1] + 1, NOTE_OFF_EVENTS[1] + NUM_BINS)
NUM_EVENTS = TIMESHIFT_EVENTS[1] + 1

# Instrument pitch ranges (reference: defaults.py:27-37); informational.
MIDI_GUITAR_BEGIN, MIDI_GUITAR_END = 40, 88
MIDI_GUITAR_RANGE = MIDI_GUITAR_END - MIDI_GUITAR_BEGIN + 1
MIDI_BASS_BEGIN, MIDI_BASS_END = 28, 62
MIDI_BASS_RANGE = MIDI_BASS_END - MIDI_BASS_BEGIN + 1


def note_on_id(pitch: int) -> int:
    """Token id of a note-on at MIDI ``pitch`` (reference: Melody.py:109-110)."""
    if not 0 <= pitch <= 127:
        raise ValueError(f"pitch {pitch} out of range [0, 127]")
    return NOTE_ON_EVENTS[0] + pitch


def note_off_id(pitch: int) -> int:
    """Token id of a note-off at MIDI ``pitch`` (reference: Melody.py:113-114)."""
    if not 0 <= pitch <= 127:
        raise ValueError(f"pitch {pitch} out of range [0, 127]")
    return NOTE_OFF_EVENTS[0] + pitch


def timeshift_id(ticks: int) -> int:
    """Token id of a binned time shift of ``ticks`` (reference: Melody.py:117-126).

    Bins are ``int((ticks - MIN_TICKS) / 30)``; ``ticks`` must lie in
    [MIN_TICKS, MAX_TICKS).
    """
    if not MIN_TICKS <= ticks < MAX_TICKS:
        raise ValueError(
            f"time shift must be in [{MIN_TICKS}, {MAX_TICKS}) ticks, got {ticks}"
        )
    binned = int((ticks - MIN_TICKS) / NUM_TICKS_IN_A_BIN)
    assert TIMESHIFT_EVENTS[0] + binned <= TIMESHIFT_EVENTS[1]
    return TIMESHIFT_EVENTS[0] + binned


def is_note_on(token: int) -> bool:
    return NOTE_ON_EVENTS[0] <= token <= NOTE_ON_EVENTS[1]


def is_note_off(token: int) -> bool:
    return NOTE_OFF_EVENTS[0] <= token <= NOTE_OFF_EVENTS[1]


def is_timeshift(token: int) -> bool:
    return TIMESHIFT_EVENTS[0] <= token <= TIMESHIFT_EVENTS[1]


def token_pitch(token: int) -> int:
    """MIDI pitch of a note-on/off token (reference: Melody.py:50-52, 63-65)."""
    if is_note_on(token):
        return token - NOTE_ON_EVENTS[0]
    if is_note_off(token):
        return token - NOTE_OFF_EVENTS[0]
    raise ValueError(f"token {token} is not a note event")


def token_tick_delay(token: int) -> int:
    """Un-binned tick delay of a time-shift token (reference: Melody.py:78-83)."""
    if not is_timeshift(token):
        raise ValueError(f"token {token} is not a time-shift event")
    return (token - TIMESHIFT_EVENTS[0]) * NUM_TICKS_IN_A_BIN
