"""The port's binding of the C++ tokenizer (``musicstyletransfer_torch/midi/
native.py``): the same token streams as the port's Python codec and as the
JAX package's ``NativeMIDIReader`` on every file of the bundled corpus, the
same errors on malformed input, the Loader's default, and the build into
``build/native/`` (never ``native/``)."""

import glob
import os

import numpy as np
import pytest

from musicstyletransfer_tpu.midi import native as jnative
from musicstyletransfer_torch.data.loader import Loader
from musicstyletransfer_torch.midi import codec as tcodec
from musicstyletransfer_torch.midi import native as tnative
from musicstyletransfer_torch.midi import smf
from musicstyletransfer_torch.midi.codec import Melody, MelodyWriter
from musicstyletransfer_torch.midi.vocab import note_on_id, timeshift_id

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "work", "data", "guitar_bass")
FILES = sorted(glob.glob(os.path.join(CORPUS, "*", "*.mid")))


@pytest.fixture(scope="module")
def readers():
    assert tnative.available(), tnative.build_error
    assert jnative.available()
    return tcodec.EventBasedMIDIReader(), tnative.NativeMIDIReader(), jnative.NativeMIDIReader()


def test_corpus_has_37_files():
    assert len(FILES) == 37


@pytest.mark.parametrize("path", FILES, ids=os.path.basename)
def test_file_tokens_equal_codec_and_jax(readers, path):
    py, nat, jnat = readers
    a, b, c = py.read_file(path), nat.read_file(path), jnat.read_file(path)
    assert len(a) == len(b) == len(c)
    for ma, mb, mc in zip(a, b, c):
        np.testing.assert_array_equal(mb.tokens, ma.tokens)
        np.testing.assert_array_equal(mb.tokens, mc.tokens)
        assert mb.bpm == ma.bpm == mc.bpm
        assert mb.resolution == ma.resolution == mc.resolution


def test_threaded_scan_equals_per_file(readers):
    _, nat, _ = readers
    scanned = nat.scan_files(FILES, n_threads=4)
    for path, melodies in zip(FILES, scanned):
        ref = nat.read_file(path)
        assert len(melodies) == len(ref)
        for a, b in zip(melodies, ref):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            assert a.bpm == b.bpm and a.resolution == b.resolution


def header(division=220, ntracks=1):
    return (b"MThd" + (6).to_bytes(4, "big") + (1).to_bytes(2, "big")
            + ntracks.to_bytes(2, "big") + division.to_bytes(2, "big"))


def track(body):
    return b"MTrk" + len(body).to_bytes(4, "big") + body


MALFORMED = {
    "not_smf": b"this is not midi at all",
    "truncated": header() + track(bytes([0x00, 0x90, 60, 100]))[:-2],
    "smpte": header(division=0xE728) + track(bytes([0x00, 0xFF, 0x2F, 0x00])),
    "bad_event": header() + track(bytes([0x00, 0x40, 60, 100, 0x00, 0xFF, 0x2F, 0x00])),
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_inputs_raise_as_jax(readers, tmp_path, name):
    """read_file and scan_files raise the JAX binding's ValueError, word for
    word (scan_files naming the file)."""
    _, nat, jnat = readers
    path = str(tmp_path / f"{name}.mid")
    with open(path, "wb") as fh:
        fh.write(MALFORMED[name])
    for call in (lambda r: r.read_file(path), lambda r: r.scan_files([path])):
        with pytest.raises(ValueError) as want:
            call(jnat)
        with pytest.raises(ValueError) as got:
            call(nat)
        assert str(got.value) == str(want.value)


def test_capacity_retry(readers, tmp_path):
    """6000 tracks overflow scan_files' first track arena: it retries with
    the sizes the scanner reports."""
    _, nat, _ = readers
    tokens = []
    for p in range(8):
        tokens += [note_on_id(60 + p), timeshift_id(120), note_on_id(60 + p)]
    mf = MelodyWriter().to_midifile(Melody(tokens=np.asarray(tokens, np.int32)))
    mf.tracks.extend([smf.EndOfTrack(tick=0)] for _ in range(2999))
    mf.format = 1
    paths = []
    for i in range(2):
        p = tmp_path / f"many-tracks-{i}.mid"
        p.write_bytes(smf.dump_midifile(mf))
        paths.append(str(p))
    for path, melodies in zip(paths, nat.scan_files(paths, n_threads=2)):
        np.testing.assert_array_equal(melodies[0].tokens, nat.read_file(path)[0].tokens)


def test_loader_reads_natively_by_default(readers):
    """Loader() reads through the port's binding, built into build/native/,
    with the Python codec's melodies; use_native=False reads with the codec;
    native/ holds only its own files."""
    native = Loader(CORPUS, 64)
    python = Loader(CORPUS, 64, use_native=False)
    assert isinstance(native.midi_reader, tnative.NativeMIDIReader)
    assert isinstance(python.midi_reader, tcodec.EventBasedMIDIReader)
    assert tnative.library_path().parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR == tnative.REPO_ROOT / "build" / "native"
    assert tnative.library_path().exists()
    assert sorted(native.melodies) == sorted(python.melodies) == ["bass", "guitar"]
    for cls in native.melodies:
        assert len(native.melodies[cls]) == len(python.melodies[cls])
        for a, b in zip(native.melodies[cls], python.melodies[cls]):
            np.testing.assert_array_equal(a.tokens, b.tokens)
    allowed = {".gitignore", "Makefile", "midi_tokenizer.cpp", "libmst_native.so"}
    assert set(os.listdir(os.path.join(REPO, "native"))) <= allowed


def test_loader_falls_back_without_a_compiler(monkeypatch, tmp_path, capsys):
    """Where the library cannot be built (no compiler), the Loader reads
    with the Python codec and says so."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_lib_load_failed", False)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    loader = Loader(CORPUS, 64)
    assert isinstance(loader.midi_reader, tcodec.EventBasedMIDIReader)
    assert "reading with the Python codec" in capsys.readouterr().out
    assert not os.listdir(tmp_path / "native")
