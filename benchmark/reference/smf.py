"""The benchmark's own Standard MIDI File code: a frozen copy of the
repository's independent SMF walker (``tests/independent_smf.py``, written
from the SMF byte format and the reference tokenizer's rules, sharing no
code with either package), plus what the benchmark needs beside it: a
writer that turns token ids into a one-track MIDI file (the requests), a
reader of a file's note messages with their absolute ticks (to judge the
MIDI a transfer hands back), and the corpus chunks both sides are fed.

Token ids: PAD, SOS, EOS = 0, 1, 2; note-on 3 + pitch; note-off 131 + pitch;
a time shift 259 + bin, a bin being 30 ticks.
"""

from __future__ import annotations

import glob
import os
import struct
from typing import Dict, List, Tuple

import numpy as np

_NOTE_ON_BASE = 3  # PAD,SOS,EOS = 0,1,2 (defaults.py:44-47)
_NOTE_OFF_BASE = 3 + 128
_TIMESHIFT_BASE = 3 + 128 + 128
_BIN = 30
_WRAP = 1000
_DEFAULT_BPM = 120.0

# data-byte count per channel-message high nibble (SMF spec, table 1)
_NDATA = {0x8: 2, 0x9: 2, 0xA: 2, 0xB: 2, 0xC: 1, 0xD: 1, 0xE: 2}


class _Cursor:
    __slots__ = ("b", "i")

    def __init__(self, b: bytes, i: int = 0):
        self.b = b
        self.i = i

    def u8(self) -> int:
        v = self.b[self.i]
        self.i += 1
        return v

    def take(self, n: int) -> bytes:
        out = self.b[self.i : self.i + n]
        if len(out) != n:
            raise ValueError("unexpected end of data")
        self.i += n
        return out

    def varint(self) -> int:
        v = 0
        while True:
            c = self.u8()
            v = (v << 7) + (c & 0x7F)
            if c < 0x80:
                return v


def _walk_track(body: bytes):
    """One pass over a track chunk: (token id list, mpqn of first SetTempo
    in this track or None)."""
    cur = _Cursor(body)
    tokens = []
    mpqn = None
    status = None  # running status
    now = 0
    origin = 0  # time of the previous note message
    while cur.i < len(body):
        now += cur.varint()
        first = cur.u8()
        if first == 0xFF:
            kind = cur.u8()
            payload = cur.take(cur.varint())
            if kind == 0x51 and mpqn is None:
                hi, mid, lo = struct.unpack(">BBB", payload)
                mpqn = (hi << 16) + (mid << 8) + lo
            if kind == 0x2F:
                break
            continue
        if first in (0xF0, 0xF7):
            cur.take(cur.varint())
            continue
        if first & 0x80:
            status = first
            d0 = cur.u8()
        else:
            if status is None:
                raise ValueError("running status without prior status byte")
            d0 = first
        nib = status >> 4
        if nib not in _NDATA:
            raise ValueError(f"bad status byte 0x{status:02x}")
        d1 = cur.u8() if _NDATA[nib] == 2 else None
        if nib in (0x8, 0x9):
            gap = now - origin
            while gap > 0:
                tokens.append(_TIMESHIFT_BASE + (gap % _WRAP) // _BIN)
                gap -= _WRAP
            tokens.append((_NOTE_ON_BASE if d1 > 0 else _NOTE_OFF_BASE) + d0)
            origin = now
    return tokens, mpqn


def walk_file(path: str):
    """Tokenize every track of an SMF file.

    Returns (track_token_lists, bpm, resolution) where track_token_lists
    includes ALL tracks (no minimum-length filtering — the caller applies
    the reference's >= 10 rule)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:4] != b"MThd":
        raise ValueError("no MThd header")
    hlen, _fmt, ntracks, division = struct.unpack(">IHHH", raw[4:14])
    if division >= 0x8000:
        raise ValueError("SMPTE division unsupported")
    pos = 8 + hlen
    per_track = []
    mpqn = None
    for _ in range(ntracks):
        tag, tlen = raw[pos : pos + 4], struct.unpack(">I", raw[pos + 4 : pos + 8])[0]
        if tag != b"MTrk":
            raise ValueError("missing MTrk")
        tokens, track_mpqn = _walk_track(raw[pos + 8 : pos + 8 + tlen])
        per_track.append(tokens)
        if mpqn is None and track_mpqn is not None:
            mpqn = track_mpqn
        pos += 8 + tlen
    bpm = _DEFAULT_BPM if mpqn is None else 6e7 / mpqn
    return per_track, bpm, division


PAD, SOS, EOS = 0, 1, 2
MIN_TRACK_TOKENS = 10  # shorter tracks are dropped (the reference's rule)


def walk_bytes(raw: bytes):
    """``walk_file`` on bytes in memory: (track token lists, bpm, division)."""
    if raw[:4] != b"MThd":
        raise ValueError("no MThd header")
    hlen, _fmt, ntracks, division = struct.unpack(">IHHH", raw[4:14])
    pos = 8 + hlen
    per_track = []
    for _ in range(ntracks):
        tag, tlen = raw[pos:pos + 4], struct.unpack(">I", raw[pos + 4:pos + 8])[0]
        if tag != b"MTrk":
            raise ValueError("missing MTrk")
        per_track.append(_walk_track(raw[pos + 8:pos + 8 + tlen])[0])
        pos += 8 + tlen
    return per_track, division


def request_tokens(raw: bytes, max_len: int) -> np.ndarray:
    """What a transfer request's MIDI holds: the first track with note
    events, tokenized and cut to ``max_len``."""
    for tokens in walk_bytes(raw)[0]:
        if tokens:
            return np.asarray(tokens[:max_len], np.int64)
    raise ValueError("no note events in the request")


def _varint(v: int) -> bytes:
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    return bytes(reversed(out))


def expected_messages(tokens) -> List[Tuple[int, int, int, int]]:
    """The note messages a one-track file written from ``tokens`` holds, as
    (delta ticks, status, pitch, velocity): time shifts add their ticks to
    the next note's delta, a note-on has velocity 127, a note-off (status
    0x80) velocity 64; special ids write nothing."""
    out, delay = [], 0
    for t in (int(x) for x in tokens):
        if t >= _TIMESHIFT_BASE:
            delay += (t - _TIMESHIFT_BASE) * _BIN
        elif t >= _NOTE_OFF_BASE:
            out.append((delay, 0x80, t - _NOTE_OFF_BASE, 64))
            delay = 0
        elif t >= _NOTE_ON_BASE:
            out.append((delay, 0x90, t - _NOTE_ON_BASE, 127))
            delay = 0
    return out


def write_midi(tokens, resolution: int = 220, bpm: float = 120.0) -> bytes:
    """A format-1 file of one track: a tempo, then ``expected_messages``."""
    mpqn = int(round(6e7 / bpm))
    body = b"\x00\xff\x51\x03" + mpqn.to_bytes(3, "big")
    for delay, status, pitch, velocity in expected_messages(tokens):
        body += _varint(delay) + bytes([status, pitch, velocity])
    body += b"\x01\xff\x2f\x00"
    return (b"MThd" + struct.pack(">IHHH", 6, 1, 1, resolution)
            + b"MTrk" + struct.pack(">I", len(body)) + body)


def note_messages(raw: bytes) -> List[Tuple[int, int, int, int]]:
    """Every note message of every track, (delta ticks since the previous
    note message, status without channel, pitch, velocity)."""
    per_track = []
    hlen, _fmt, ntracks, _division = struct.unpack(">IHHH", raw[4:14])
    pos = 8 + hlen
    for _ in range(ntracks):
        tlen = struct.unpack(">I", raw[pos + 4:pos + 8])[0]
        cur, end = _Cursor(raw, pos + 8), pos + 8 + tlen
        status, now, origin = None, 0, 0
        while cur.i < end:
            now += cur.varint()
            first = cur.u8()
            if first == 0xFF:
                kind = cur.u8()
                cur.take(cur.varint())
                if kind == 0x2F:
                    break
                continue
            if first in (0xF0, 0xF7):
                cur.take(cur.varint())
                continue
            if first & 0x80:
                status, d0 = first, cur.u8()
            else:
                d0 = first
            d1 = cur.u8() if _NDATA[status >> 4] == 2 else None
            if status >> 4 in (0x8, 0x9):
                per_track.append((now - origin, status & 0xF0, d0, d1))
                origin = now
        pos += 8 + tlen
    return per_track


def corpus_chunks(data_dir: str, max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Every class directory's melodies (tracks of at least 10 tokens), in
    sorted order, cut into chunks of ``max_len``: (chunks [N, max_len]
    PAD-padded, classes [N]); the class index is the sorted directory's."""
    rows, classes = [], []
    names = sorted(d for d in os.listdir(data_dir) if os.path.isdir(os.path.join(data_dir, d)))
    for c, name in enumerate(names):
        for path in sorted(glob.glob(os.path.join(data_dir, name, "*.mid"))):
            for tokens in walk_file(path)[0]:
                if len(tokens) < MIN_TRACK_TOKENS:
                    continue
                for start in range(0, len(tokens), max_len):
                    rows.append(tokens[start:start + max_len])
                    classes.append(c)
    chunks = np.full((len(rows), max_len), PAD, np.int64)
    for i, r in enumerate(rows):
        chunks[i, :len(r)] = r
    return chunks, np.asarray(classes, np.int64)


def layout(chunks: np.ndarray) -> Dict[str, np.ndarray]:
    """Training rows from chunks [N, L]: tokens [N, L+1] (SOS first),
    seq_lens [N] (the SOS counted), labels [N, L+1] (the chunk, then EOS
    at the row's length, PAD after)."""
    n, L = chunks.shape
    lens = (chunks != PAD).sum(1)
    tokens = np.concatenate([np.full((n, 1), SOS, np.int64), chunks], 1)
    labels = np.concatenate([chunks, np.full((n, 1), PAD, np.int64)], 1)
    labels[np.arange(n), lens] = EOS
    return {"tokens": tokens, "seq_lens": lens + 1, "labels": labels}
