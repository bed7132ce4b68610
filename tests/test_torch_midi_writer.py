"""PyTorch port, the batched MIDI writer (``midi/native_writer.py`` over
``midi/csrc/midi_writer.cpp``) and ``inference.service.results_of`` through
it: every file is byte for byte what ``MelodyWriter`` and
``smf.dump_midifile`` write for the row's melody, every token array is
``melody_from_ids(row).tokens`` in value and dtype; without the library
``results_of`` writes with ``MelodyWriter`` and gives the same results, and
its counters say which way each row was written."""

import os
import sys
import threading

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from musicstyletransfer_torch import tracing
from musicstyletransfer_torch.data.dataset import chunk_melodies
from musicstyletransfer_torch.data.loader import Loader
from musicstyletransfer_torch.inference import service
from musicstyletransfer_torch.midi import native, native_writer, smf
from musicstyletransfer_torch.midi.codec import MelodyWriter, melody_from_ids
from musicstyletransfer_torch.midi.vocab import (EOS_ID, NUM_EVENTS, PAD_ID, SOS_ID,
                                                 TIMESHIFT_EVENTS, note_off_id, note_on_id)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "work", "data", "guitar_bass")
T = 130  # K1's row at the canonical widths: 2 * (64 + 1)
LONGEST_SHIFT = TIMESHIFT_EVENTS[1]  # 990 ticks


def python_file(row) -> bytes:
    return smf.dump_midifile(MelodyWriter().to_midifile(melody_from_ids(row)))


def native_files(rows):
    return native_writer.write_midi(*native_writer.pack(rows))


def corpus_rows():
    """Every chunk of the corpus at L=64, then EOS, then PAD to T."""
    chunks, _ = chunk_melodies(Loader(CORPUS, 64).melodies, 64)
    rows = np.full((len(chunks), T), PAD_ID, np.int64)
    for i, chunk in enumerate(chunks):
        toks = chunk[chunk != PAD_ID]
        rows[i, :len(toks)] = toks
        rows[i, len(toks)] = EOS_ID
    return list(rows)


def random_rows(high):
    """Seeded rows of ids in [0, high): specials and notes anywhere."""
    rng = np.random.default_rng(18)
    return list(rng.integers(0, high, size=(64, T)))


def shift_run_rows(shifts):
    """A note-on, ``shifts`` of the longest time shift (990 ticks each),
    its note-off, one more shift and a note-on: the note-off's delta grows
    with the run."""
    row = [SOS_ID, note_on_id(40)] + [LONGEST_SHIFT] * shifts + [note_off_id(40)]
    return [np.asarray(row + [LONGEST_SHIFT, note_on_id(41), EOS_ID], np.int64)]


def no_note_rows():
    return [np.asarray([SOS_ID, EOS_ID, PAD_ID], np.int64),
            np.asarray([LONGEST_SHIFT, 260, 261, EOS_ID], np.int64),
            np.full(T, PAD_ID, np.int64),
            np.asarray([400, 293, 1000], np.int64)]


def empty_rows():
    return [np.zeros(0, np.int64), np.asarray([note_on_id(60)], np.int64),
            np.zeros(0, np.int64)]


def ragged_rows():
    """One request's rows of different lengths, int32 as the streaming
    engine hands them over."""
    rng = np.random.default_rng(2018)
    return [rng.integers(0, NUM_EVENTS, size=n).astype(np.int32) for n in (1, 7, 64, 129, 3)]


CASES = {
    "corpus": corpus_rows,
    "random_with_specials": lambda: random_rows(NUM_EVENTS),
    "ids_past_the_vocabulary": lambda: random_rows(400),
    "varlen_2_bytes": lambda: shift_run_rows(1),  # 990 ticks
    "varlen_3_bytes": lambda: shift_run_rows(17),  # 16,830 ticks
    "varlen_4_bytes": lambda: shift_run_rows(2119),  # 2,097,810 ticks
    "varlen_5_bytes": lambda: shift_run_rows(271147),  # 268,435,530 ticks
    "no_notes": no_note_rows,
    "empty": empty_rows,
    "ragged": ragged_rows,
}


@pytest.fixture(scope="module", autouse=True)
def library():
    assert native_writer.load_library() is not None, native_writer.LIBRARY.error


def as_requests(rows):
    """Rows two classes a request (the last request may hold one)."""
    return [{c: r for c, r in enumerate(rows[i:i + 2])} for i in range(0, len(rows), 2)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_files_and_tokens_equal_the_python_writer(case):
    rows = CASES[case]()
    want = [python_file(r) for r in rows]
    assert native_files(rows) == want
    requests = as_requests(rows)
    got = service.results_of(requests, MelodyWriter())
    k = 0
    for request, result in zip(requests, got):
        assert list(result.midi_by_class) == list(request)
        assert list(result.tokens_by_class) == list(request)
        for c, row in request.items():
            assert result.midi_by_class[c] == want[k]
            tokens, expected = result.tokens_by_class[c], melody_from_ids(row).tokens
            assert tokens.dtype == expected.dtype
            np.testing.assert_array_equal(tokens, expected)
            k += 1


def test_results_do_not_share_the_scratch_with_later_calls():
    """The calls work in a scratch buffer of their thread; what they return
    is copied out, so a later call changes nothing already returned."""
    first_rows, later_rows = random_rows(NUM_EVENTS)[:6], random_rows(400)[6:40]
    first = service.results_of(as_requests(first_rows), MelodyWriter())
    service.results_of(as_requests(later_rows), MelodyWriter())
    native_files(later_rows)
    for result, (a, b) in zip(first, zip(first_rows[::2], first_rows[1::2])):
        assert result.midi_by_class == {0: python_file(a), 1: python_file(b)}
        np.testing.assert_array_equal(result.tokens_by_class[0], melody_from_ids(a).tokens)
        np.testing.assert_array_equal(result.tokens_by_class[1], melody_from_ids(b).tokens)


def test_threads_write_at_once(monkeypatch):
    """Each thread has its own scratch and the counters take every row:
    twelve threads at once, switching every microsecond, get what the
    Python writer gives."""
    rng = np.random.default_rng(4)
    work = [as_requests([rng.integers(0, NUM_EVENTS, size=n).astype(np.int32)
                         for n in rng.integers(0, 200, size=16)]) for _ in range(12)]
    want = [[{c: python_file(row) for c, row in r.items()} for r in w] for w in work]
    monkeypatch.setattr(service.results_of, "native_rows", 0)
    got = [[] for _ in work]

    def run(k):
        for _ in range(20):
            got[k].append([r.midi_by_class for r in service.results_of(work[k], MelodyWriter())])

    threads = [threading.Thread(target=run, args=(k,)) for k in range(len(work))]
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
    for k in range(len(work)):
        assert len(got[k]) == 20 and all(files == want[k] for files in got[k])
    assert service.results_of.native_rows == 20 * 16 * len(work)


@pytest.mark.parametrize("offsets", [[0, 5, 3, 9], [0, 4, 200], [-1, 4], [0, 131]])
def test_offsets_outside_the_tokens_are_refused(offsets):
    tokens = np.full(130, note_on_id(60), np.int32)
    for call in (native_writer.write_midi, native_writer.event_ids):
        with pytest.raises(ValueError, match="row offsets"):
            call(tokens, np.asarray(offsets))


@pytest.mark.parametrize("varlen_bytes, shifts", [(2, 1), (3, 17), (4, 2119), (5, 271147)])
def test_shift_runs_reach_their_varlen_size(varlen_bytes, shifts):
    """The runs above do write the note-off's delta in that many bytes
    (after MThd 14, MTrk 8, SetTempo 7 and the first note-on's 4 bytes)."""
    body = native_files(shift_run_rows(shifts))[0][14 + 8 + 7 + 4:]
    delta = body[:varlen_bytes]
    assert all(b & 0x80 for b in delta[:-1]) and not delta[-1] & 0x80
    assert body[varlen_bytes] == 0x80  # the note-off's status byte


def test_without_the_library_results_of_writes_in_python(monkeypatch, tmp_path):
    """With no compiler to build the library, ``results_of`` writes with
    ``MelodyWriter``, gives the native path's results and counts its rows
    as Python's; with the library it counts them as native."""
    rows = random_rows(NUM_EVENTS)[:9] + ragged_rows()
    requests = as_requests(rows)
    monkeypatch.setattr(service.results_of, "native_rows", 0)
    monkeypatch.setattr(service.results_of, "python_rows", 0)
    natively = service.results_of(requests, MelodyWriter())
    assert (service.results_of.native_rows, service.results_of.python_rows) == (len(rows), 0)

    monkeypatch.setattr(native_writer.LIBRARY, "lib", None)
    monkeypatch.setattr(native_writer.LIBRARY, "failed", False)
    monkeypatch.setattr(native_writer.LIBRARY, "error", "")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    in_python = service.results_of(requests, MelodyWriter())
    assert native_writer.load_library() is None
    assert "no-such-compiler" in native_writer.LIBRARY.error
    assert not os.listdir(tmp_path / "native")
    assert (service.results_of.native_rows, service.results_of.python_rows) == (len(rows),
                                                                                len(rows))
    for a, b in zip(natively, in_python):
        assert a.midi_by_class == b.midi_by_class
        assert list(a.tokens_by_class) == list(b.tokens_by_class)
        for c in a.tokens_by_class:
            assert a.tokens_by_class[c].dtype == b.tokens_by_class[c].dtype
            np.testing.assert_array_equal(a.tokens_by_class[c], b.tokens_by_class[c])


@pytest.mark.parametrize("way", ["native", "python"])
def test_results_of_records_detokenize_then_midi_write(monkeypatch, way):
    if way == "python":
        monkeypatch.setattr(native_writer.LIBRARY, "lib", None)
        monkeypatch.setattr(native_writer.LIBRARY, "failed", True)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        service.results_of(as_requests(random_rows(NUM_EVENTS)[:4]), MelodyWriter())
    spans = tracing.spans()
    tracing.clear()
    assert [s.name for s in spans] == ["service.detokenize", "service.midi_write"]
    assert spans[0].end_ns <= spans[1].start_ns
