"""Minimal Standard MIDI File (SMF) byte codec.

The PyTorch port's own copy of ``musicstyletransfer_tpu/midi/smf.py`` (the port imports
nothing of the JAX package); the two stay in step, and
``tests/test_torch_host_layers.py`` holds them to the same results.

The reference delegates MIDI byte parsing to the py2-era ``python-midi``
package (reference: MIDIUtil/midi_io.py:4,39). This is a from-scratch
reader/writer covering the subset the pipeline needs — note-on/off, set-tempo,
end-of-track, delta ticks, running status, resolution — with the same
semantics ``python-midi`` exposes to the reference tokenizer:

- every event carries a *delta* ``tick`` relative to the previous event in
  its track;
- note-on with velocity 0 is kept as a note-on event (no silent conversion
  to note-off);
- ``SetTempo.bpm`` is ``6e7 / mpqn`` as a float;
- unknown channel/meta/sysex events are parsed (so tick accounting stays
  correct) and preserved as ``OtherEvent``/``MetaEvent``.

Writing emits format-1 files without running-status compression, matching
what ``python-midi`` produced for the reference's ``MelodyWriter``
(reference: midi_io.py:96-132).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Union


@dataclasses.dataclass
class NoteOn:
    tick: int
    pitch: int
    velocity: int
    channel: int = 0


@dataclasses.dataclass
class NoteOff:
    tick: int
    pitch: int
    velocity: int = 64
    channel: int = 0


@dataclasses.dataclass
class SetTempo:
    tick: int
    mpqn: int  # microseconds per quarter note

    @property
    def bpm(self) -> float:
        # python-midi SetTempoEvent.get_bpm(): float(6e7) / mpqn
        return float(6e7) / float(self.mpqn)

    @classmethod
    def from_bpm(cls, bpm: float, tick: int = 0) -> "SetTempo":
        # python-midi SetTempoEvent.set_bpm(): mpqn = int(float(6e7) / bpm)
        return cls(tick=tick, mpqn=int(float(6e7) / bpm))


@dataclasses.dataclass
class EndOfTrack:
    tick: int


@dataclasses.dataclass
class MetaEvent:
    tick: int
    meta_type: int
    data: bytes


@dataclasses.dataclass
class OtherEvent:
    """Non-note channel event (control change, program change, ...)."""

    tick: int
    status: int
    data: bytes


Event = Union[NoteOn, NoteOff, SetTempo, EndOfTrack, MetaEvent, OtherEvent]
Track = List[Event]


@dataclasses.dataclass
class MidiFile:
    format: int
    resolution: int
    tracks: List[Track]


class SmfError(ValueError):
    pass


def _read_varlen(buf: bytes, pos: int) -> tuple[int, int]:
    value = 0
    while True:
        if pos >= len(buf):
            raise SmfError("truncated variable-length quantity")
        byte = buf[pos]
        pos += 1
        value = (value << 7) | (byte & 0x7F)
        if not byte & 0x80:
            return value, pos


def _write_varlen(value: int) -> bytes:
    if value < 0:
        raise SmfError(f"negative varlen {value}")
    chunks = [value & 0x7F]
    value >>= 7
    while value:
        chunks.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(chunks))


# Data byte counts for channel messages by high nibble.
_CHANNEL_DATA_BYTES = {
    0x80: 2,  # note off
    0x90: 2,  # note on
    0xA0: 2,  # polyphonic aftertouch
    0xB0: 2,  # control change
    0xC0: 1,  # program change
    0xD0: 1,  # channel aftertouch
    0xE0: 2,  # pitch bend
}


def _parse_track(buf: bytes) -> Track:
    events: Track = []
    pos = 0
    running_status: Optional[int] = None
    while pos < len(buf):
        tick, pos = _read_varlen(buf, pos)
        if pos >= len(buf):
            raise SmfError("truncated event")
        status = buf[pos]
        if status >= 0x80:
            pos += 1
            if status < 0xF0:
                running_status = status
        else:
            # Running status: reuse previous channel status byte.
            if running_status is None:
                raise SmfError("data byte with no running status")
            status = running_status

        if status == 0xFF:  # meta event
            if pos >= len(buf):
                raise SmfError("truncated meta event")
            meta_type = buf[pos]
            pos += 1
            length, pos = _read_varlen(buf, pos)
            data = buf[pos : pos + length]
            if len(data) != length:
                raise SmfError("truncated meta data")
            pos += length
            if meta_type == 0x51:
                if length != 3:
                    raise SmfError("SetTempo length != 3")
                mpqn = (data[0] << 16) | (data[1] << 8) | data[2]
                events.append(SetTempo(tick=tick, mpqn=mpqn))
            elif meta_type == 0x2F:
                events.append(EndOfTrack(tick=tick))
                break
            else:
                events.append(MetaEvent(tick=tick, meta_type=meta_type, data=data))
        elif status in (0xF0, 0xF7):  # sysex
            length, pos = _read_varlen(buf, pos)
            data = buf[pos : pos + length]
            if len(data) != length:
                raise SmfError("truncated sysex data")
            pos += length
            events.append(OtherEvent(tick=tick, status=status, data=data))
        else:
            kind = status & 0xF0
            n = _CHANNEL_DATA_BYTES.get(kind)
            if n is None:
                raise SmfError(f"unknown status byte 0x{status:02x}")
            data = buf[pos : pos + n]
            if len(data) != n:
                raise SmfError("truncated channel event")
            pos += n
            channel = status & 0x0F
            if kind == 0x90:
                events.append(
                    NoteOn(tick=tick, pitch=data[0], velocity=data[1], channel=channel)
                )
            elif kind == 0x80:
                events.append(
                    NoteOff(tick=tick, pitch=data[0], velocity=data[1], channel=channel)
                )
            else:
                events.append(OtherEvent(tick=tick, status=status, data=data))
    return events


def read_midifile(path: str) -> MidiFile:
    """Parse an SMF file into tracks of delta-ticked events."""
    with open(path, "rb") as fh:
        buf = fh.read()
    return parse_midifile(buf)


def parse_midifile(buf: bytes) -> MidiFile:
    if len(buf) < 14 or buf[0:4] != b"MThd":
        raise SmfError("not an SMF file (missing MThd)")
    header_len = struct.unpack(">I", buf[4:8])[0]
    if header_len < 6:
        raise SmfError(f"bad MThd length {header_len}")
    fmt, ntracks, division = struct.unpack(">HHH", buf[8:14])
    if division & 0x8000:
        raise SmfError("SMPTE time division not supported")
    pos = 8 + header_len
    tracks: List[Track] = []
    for _ in range(ntracks):
        if pos + 8 > len(buf):
            raise SmfError("truncated track header")
        if buf[pos : pos + 4] != b"MTrk":
            raise SmfError("missing MTrk chunk")
        length = struct.unpack(">I", buf[pos + 4 : pos + 8])[0]
        body = buf[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise SmfError("truncated track body")
        pos += 8 + length
        tracks.append(_parse_track(body))
    return MidiFile(format=fmt, resolution=division, tracks=tracks)


def _encode_event(ev: Event) -> bytes:
    out = _write_varlen(ev.tick)
    if isinstance(ev, NoteOn):
        out += bytes([0x90 | (ev.channel & 0x0F), ev.pitch & 0x7F, ev.velocity & 0x7F])
    elif isinstance(ev, NoteOff):
        out += bytes([0x80 | (ev.channel & 0x0F), ev.pitch & 0x7F, ev.velocity & 0x7F])
    elif isinstance(ev, SetTempo):
        out += bytes([0xFF, 0x51, 0x03]) + ev.mpqn.to_bytes(3, "big")
    elif isinstance(ev, EndOfTrack):
        out += bytes([0xFF, 0x2F, 0x00])
    elif isinstance(ev, MetaEvent):
        out += bytes([0xFF, ev.meta_type]) + _write_varlen(len(ev.data)) + ev.data
    elif isinstance(ev, OtherEvent):
        if ev.status in (0xF0, 0xF7):
            out += bytes([ev.status]) + _write_varlen(len(ev.data)) + ev.data
        else:
            out += bytes([ev.status]) + ev.data
    else:
        raise SmfError(f"cannot encode event {ev!r}")
    return out


def write_midifile(path: str, mf: MidiFile) -> None:
    with open(path, "wb") as fh:
        fh.write(dump_midifile(mf))


def dump_midifile(mf: MidiFile) -> bytes:
    out = b"MThd" + struct.pack(">IHHH", 6, mf.format, len(mf.tracks), mf.resolution)
    for track in mf.tracks:
        body = b"".join(_encode_event(ev) for ev in track)
        if not track or not isinstance(track[-1], EndOfTrack):
            body += _encode_event(EndOfTrack(tick=0))
        out += b"MTrk" + struct.pack(">I", len(body)) + body
    return out
