"""PyTorch port, the service's request tokenizing (``inference.service.
tokens_from_midi``): one call of the native request tokenizer
(``midi/native_request.py`` over ``midi/csrc/request_tokenizer.cpp``), with
``tokens_in_python`` (``smf.parse_midifile`` + ``codec.tokenize_track``) as
the plain route. Both routes are held to the JAX package's
``StyleTransferService._tokens_from_midi`` on the same bytes: the same int32
tokens on the convert pool, the corpus and the edge files, the same
exception type and message on the files the C reader declines. Threads get
their own tokens in fresh arrays; without the library the plain route runs;
the counters say which route each file took."""

import glob
import os
import struct
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from musicstyletransfer_tpu.inference.service import StyleTransferService as JaxService
from musicstyletransfer_torch import tracing
from musicstyletransfer_torch.data.dataset import chunk_melodies
from musicstyletransfer_torch.data.loader import Loader
from musicstyletransfer_torch.inference import service
from musicstyletransfer_torch.midi import native_request, smf
from musicstyletransfer_torch.midi.codec import MelodyWriter, melody_from_ids

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "work", "data", "guitar_bass")
CORPUS_FILES = sorted(glob.glob(os.path.join(CORPUS, "*", "*.mid")))


@pytest.fixture(scope="module", autouse=True)
def library():
    assert native_request.load_library() is not None, native_request.LIBRARY.error


@pytest.fixture
def counts(monkeypatch):
    """The counters from zero: (native_files, python_files) as a call."""
    monkeypatch.setattr(service.tokens_from_midi, "native_files", 0)
    monkeypatch.setattr(service.tokens_from_midi, "python_files", 0)
    return lambda: (service.tokens_from_midi.native_files,
                    service.tokens_from_midi.python_files)


def convert_pool():
    """canonical_convert's requests: the corpus's 64-token chunks with at
    least 16 tokens and a note, each written as a one-track MIDI file."""
    chunks, _ = chunk_melodies(Loader(CORPUS, 64).melodies, 64)
    pool = []
    for chunk in chunks:
        toks = chunk[chunk != 0]
        if len(toks) >= 16 and ((toks >= 3) & (toks < 259)).any():
            pool.append(smf.dump_midifile(MelodyWriter().to_midifile(melody_from_ids(toks))))
    return pool


def varlen(value: int, n_bytes: int = 0) -> bytes:
    """``value`` as a variable-length number, padded to ``n_bytes``."""
    groups = [value & 0x7F]
    value >>= 7
    while value or len(groups) < n_bytes:
        groups.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(groups))


def midi(*tracks: bytes, division: int = 220, n_tracks=None) -> bytes:
    """An SMF file of the given MTrk bodies."""
    n = len(tracks) if n_tracks is None else n_tracks
    out = b"MThd" + struct.pack(">IHHH", 6, 1, n, division)
    for body in tracks:
        out += b"MTrk" + struct.pack(">I", len(body)) + body
    return out


END = b"\x00\xff\x2f\x00"
TEMPO = b"\x00\xff\x51\x03\x07\xa1\x20"


def notes(*events, channel: int = 0) -> bytes:
    """Note events (delta, status nibble, pitch, velocity); a status nibble
    of None writes the event in running status."""
    out = b""
    for delta, kind, pitch, velocity in events:
        status = b"" if kind is None else bytes([kind | channel])
        out += varlen(delta) + status + bytes([pitch, velocity])
    return out


MELODY = notes((0, 0x90, 60, 100), (240, 0x80, 60, 64), (30, 0x90, 62, 90),
               (2500, 0x90, 62, 0), (1000, 0x90, 64, 80), (3000, 0x80, 64, 0))

EDGE_FILES = {
    "empty_first_track": midi(b"", MELODY + END),
    "tempo_only_first_track": midi(TEMPO + END, MELODY + END),
    "velocity_0_note_ons": midi(notes((0, 0x90, 60, 90), (120, 0x90, 60, 0),
                                      (1000, 0x90, 61, 0)) + END),
    "running_status": midi(notes((0, 0x90, 60, 90), (120, None, 60, 0), (60, None, 62, 70),
                                 (2001, 0x80, 62, 0), (5, None, 63, 9)) + END),
    "running_status_over_meta_and_sysex": midi(
        notes((0, 0x90, 60, 90)) + b"\x10\xff\x01\x02hi\x05\xf0\x02\x7e\xf7"
        + notes((7, None, 60, 0)) + END),
    "several_note_tracks": midi(TEMPO + END, MELODY + END,
                                notes((0, 0x90, 40, 1), (9, 0x80, 40, 0)) + END),
    "notes_then_none_then_notes": midi(MELODY + END, TEMPO + END, MELODY + END),
    "pitch_over_127_in_a_later_track": midi(MELODY + END, notes((0, 0x90, 200, 1)) + END),
    "other_channel_messages": midi(b"\x00\xc0\x05\x00\xb0\x07\x64\x10\xe0\x00\x40"
                                   + notes((3, 0x90, 70, 5), channel=9)
                                   + b"\x04\xa9\x46\x10\x02\xd9\x30" + notes((8, 0x80, 70, 0))
                                   + END),
    "ticks_between_notes_carried_over_other_events": midi(
        notes((100, 0x90, 60, 1)) + b"\x83\x60\xb0\x07\x64" + notes((1, 0x80, 60, 0)) + END),
    "gap_of_exact_thousands": midi(notes((0, 0x90, 60, 1), (3000, 0x80, 60, 0),
                                         (1000, 0x90, 61, 1)) + END),
    "long_gap_4_byte_delta": midi(notes((0, 0x90, 60, 1), (2_097_810, 0x80, 60, 0)) + END),
    "padded_5_byte_delta": midi(varlen(1999, 5) + b"\x90\x3c\x40" + END),
    "data_after_end_of_track": midi(MELODY + END + b"\x00\x90\x3c\x40"),
    "no_end_of_track": midi(MELODY),
    "header_longer_than_6": (b"MThd" + struct.pack(">IHHH", 8, 1, 1, 220) + b"\x00\x00"
                             + b"MTrk" + struct.pack(">I", len(MELODY + END)) + MELODY + END),
    "bytes_after_the_last_track": midi(MELODY + END) + b"junk",
}

# Bytes the C reader declines: the plain route raises on them, or tokenizes.
DECLINED_FILES = {
    "not_smf": b"RIFF" + b"\x00" * 20,
    "too_short": b"MThd\x00\x00",
    "header_length_under_6": b"MThd" + struct.pack(">IHHH", 5, 1, 1, 220),
    "smpte_division": midi(MELODY + END, division=0xE728),
    "truncated_track": midi(MELODY + END)[:-3],
    "missing_track": midi(MELODY + END, n_tracks=2),
    "missing_mtrk_tag": midi(MELODY + END).replace(b"MTrk", b"MTrX"),
    "truncated_event": midi(MELODY + b"\x00\x90\x3c"),
    "truncated_delta": midi(MELODY + b"\x81"),
    "truncated_meta": midi(MELODY + b"\x00\xff\x01\x05ab"),
    "truncated_sysex": midi(MELODY + b"\x00\xf0\x05ab"),
    "set_tempo_of_2_bytes": midi(b"\x00\xff\x51\x02\x07\xa1" + MELODY + END),
    "set_tempo_of_4_bytes_later": midi(MELODY + b"\x00\xff\x51\x04\x00\x07\xa1\x20" + END),
    "data_byte_without_running_status": midi(b"\x00\x3c\x00" + MELODY + END),
    "unknown_status_byte": midi(MELODY + b"\x00\xf1\x00" + END),
    "pitch_over_127": midi(notes((0, 0x90, 60, 1), (10, 0x80, 128, 0)) + END),
    "pitch_over_127_at_velocity_0": midi(notes((5, 0x90, 255, 0)) + END),
    "error_in_a_later_track": midi(MELODY + END, b"\x00\xf4" + END),
    "no_notes": midi(TEMPO + END, b"\x00\xc0\x05" + END),
    "no_tracks": midi(),
    "empty_tracks": midi(b"", b""),
    "delta_of_9_bytes": midi(varlen(1234, 9) + b"\x90\x3c\x40" + END),
    "ticks_past_2_to_the_62_in_a_later_track": midi(
        MELODY + END, (varlen((1 << 56) - 1) + b"\xb0\x07\x64") * 80 + END),
}


def tokens_in_jax(midi_bytes, max_len):
    """The JAX package's request tokenizing at the cut ``max_len``."""
    return JaxService._tokens_from_midi(SimpleNamespace(max_seq_len=max_len), midi_bytes)


def outcome(fn, data, max_len=64):
    """(tokens, dtype) or (exception type's name, message) of ``fn(data,
    max_len)``: each package raises its own ``smf.SmfError``."""
    try:
        toks = fn(data, max_len)
    except Exception as exc:  # compared, type and message, across the routes
        return type(exc).__name__, str(exc)
    return toks.tolist(), toks.dtype.name


def assert_routes_agree(data, max_len=64):
    """The service's tokens or error, the plain route's and the JAX
    package's are the same; the first as a value."""
    want = outcome(tokens_in_jax, data, max_len)
    assert outcome(service.tokens_from_midi, data, max_len) == want
    assert outcome(service.tokens_in_python, data, max_len) == want
    return want


def test_convert_pool_native_equals_python(counts):
    pool = convert_pool()
    assert len(pool) > 800
    for data in pool:
        want = tokens_in_jax(data, 64)
        got = service.tokens_from_midi(data, 64)
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)
        assert np.array_equal(service.tokens_in_python(data, 64), want)
    assert counts() == (len(pool), 0)


@pytest.mark.parametrize("max_len", [16, 64, 2046])
def test_corpus_native_equals_python(max_len, counts):
    for path in CORPUS_FILES:
        with open(path, "rb") as fh:
            data = fh.read()
        want = tokens_in_jax(data, max_len)
        got = native_request.first_track_tokens(data, max_len)
        assert got is not None, path
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want), path
        assert np.array_equal(service.tokens_from_midi(data, max_len), want)
        assert np.array_equal(service.tokens_in_python(data, max_len), want)
    assert counts() == (len(CORPUS_FILES), 0)


@pytest.mark.parametrize("name", sorted(EDGE_FILES))
@pytest.mark.parametrize("max_len", [0, 3, 64])
def test_edge_files_native_equal_python(name, max_len, counts):
    data = EDGE_FILES[name]
    want = tokens_in_jax(data, max_len)
    got = native_request.first_track_tokens(data, max_len)
    assert got is not None
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    assert assert_routes_agree(data, max_len) == (want.tolist(), "int32")
    assert counts() == (1, 0)


def test_edge_files_tokens():
    """What the quirks give, written out: classification by velocity, time
    shifts delta % 1000 an iteration, ticks of other events carried to the
    next note."""
    tok = service.tokens_from_midi
    assert tok(EDGE_FILES["velocity_0_note_ons"], 64).tolist() == [
        3 + 60, 259 + 4, 131 + 60, 259, 131 + 61]
    assert tok(EDGE_FILES["gap_of_exact_thousands"], 64).tolist() == [
        3 + 60, 259, 259, 259, 131 + 60, 259, 3 + 61]
    assert tok(EDGE_FILES["ticks_between_notes_carried_over_other_events"], 64).tolist() == [
        259 + 3, 3 + 60, 259 + 16, 131 + 60]
    assert tok(EDGE_FILES["several_note_tracks"], 64).tolist() == tok(
        midi(MELODY + END), 64).tolist()


@pytest.mark.parametrize("name", sorted(DECLINED_FILES))
def test_declined_files_take_the_python_route(name, counts):
    data = DECLINED_FILES[name]
    assert native_request.first_track_tokens(data, 64) is None
    want = assert_routes_agree(data)
    assert counts() == (0, 1)
    if name in ("no_notes", "no_tracks", "empty_tracks"):
        assert want == ("ValueError", "no note events in MIDI request")


def test_negative_cut_and_other_buffers_take_the_python_route(counts):
    data = midi(MELODY + END)
    assert_routes_agree(data, -2)
    assert_routes_agree(bytearray(data))
    assert counts() == (0, 2)


def test_a_long_cut_grows_the_scratch(counts):
    """A cut longer than any scratch so far takes the native route too."""
    data = EDGE_FILES["long_gap_4_byte_delta"]
    want = assert_routes_agree(data, (1 << 20) + 1)
    assert len(want[0]) == 2100  # two notes and 2,098 shifts
    assert len(native_request._scratch.tokens) == (1 << 20) + 1
    assert counts() == (1, 0)


def test_threads_get_their_own_tokens(counts):
    """More threads than cores tokenizing different files at once, each at
    its own cut, with the interpreter switching threads often, get what one
    thread gets, and the counters lose no file."""
    files = [open(p, "rb").read() for p in CORPUS_FILES[:8]]
    cuts = [16, 64, 2046, 5000, 33, 64, 7, 4100]
    n_threads, calls = max(8, (os.cpu_count() or 1) + 1), 50
    want = [tokens_in_jax(d, L) for d, L in zip(files, cuts)]
    got = [[] for _ in range(n_threads)]
    start = threading.Barrier(n_threads)

    def work(i):
        start.wait(timeout=30)
        for _ in range(calls):
            got[i].append(service.tokens_from_midi(files[i % 8], cuts[i % 8]))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for i, runs in enumerate(got):
        assert len(runs) == calls
        for toks in runs:
            assert np.array_equal(toks, want[i % 8])
    assert counts() == (n_threads * calls, 0)


def test_returned_arrays_are_fresh():
    """Writing into a returned array changes no later result."""
    data = EDGE_FILES["several_note_tracks"]
    first = service.tokens_from_midi(data, 64)
    want = first.copy()
    first[:] = -7
    second = service.tokens_from_midi(data, 64)
    assert np.array_equal(second, want)
    assert not np.shares_memory(first, second)
    assert second.flags.owndata and second.flags.writeable


def test_without_the_library_the_python_route_runs(monkeypatch, counts):
    monkeypatch.setattr(native_request, "load_library", lambda: None)
    for name in ("several_note_tracks", "running_status"):
        assert_routes_agree(EDGE_FILES[name])
    assert_routes_agree(DECLINED_FILES["smpte_division"])
    assert counts() == (0, 3)


def test_library_that_does_not_build(monkeypatch, tmp_path):
    """With no compiler the loader returns None, says why, and writes no
    library."""
    from musicstyletransfer_torch.midi import native

    monkeypatch.setattr(native_request.LIBRARY, "lib", None)
    monkeypatch.setattr(native_request.LIBRARY, "failed", False)
    monkeypatch.setattr(native_request.LIBRARY, "error", "")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert native_request.load_library() is None
    assert "no-such-compiler" in native_request.LIBRARY.error
    assert native_request.first_track_tokens(midi(MELODY + END), 64) is None
    assert not os.listdir(tmp_path / "native")


@pytest.mark.parametrize("route", ["native", "python"])
def test_tokenize_records_a_span_a_file(monkeypatch, route):
    if route == "python":
        monkeypatch.setattr(native_request, "load_library", lambda: None)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for name in ("several_note_tracks", "running_status", "empty_first_track"):
            service.tokens_from_midi(EDGE_FILES[name], 64)
        with pytest.raises(ValueError):
            service.tokens_from_midi(DECLINED_FILES["no_notes"], 64)
    spans = tracing.spans()
    tracing.clear()
    assert [s.name for s in spans] == ["service.tokenize"] * 4
    assert service.tokens_from_midi(EDGE_FILES["running_status"], 64) is not None
    assert tracing.spans() == []  # no span without a profiler
