"""The readers of the program's request tokenizing: ``midi_in_us.convert``
(microseconds a file of the ``service.tokenize`` spans that started in the
traced window) and ``midi_in_native_share.convert`` (the share of files its
counters put on the native route); each reads nothing where there is
nothing to read, as on a program without the span or the counters."""

import types

import pytest

from helpers import harness
from musicstyletransfer_torch import tracing
from musicstyletransfer_torch.inference import service

MS = 10**6  # ns
WINDOW = (100 * MS, 200 * MS)


def context(trace=True):
    t = types.SimpleNamespace(start_ns=WINDOW[0], end_ns=WINDOW[1]) if trace else None
    return types.SimpleNamespace(trace=t, attempted=4)


def test_midi_in_us_sums_the_windows_tokenize_spans(monkeypatch):
    spans = [tracing.Span("service.tokenize", a * MS, (a + n) * MS)
             for a, n in ((110, 2), (150, 3), (99, 40), (201, 5))]
    spans.append(tracing.Span("service.midi_write", 120 * MS, 130 * MS))
    monkeypatch.setattr(tracing, "spans", lambda start_ns=0, end_ns=None: [
        s for s in spans if start_ns <= s.start_ns <= end_ns])
    reader = harness.Cell.reader("midi_in_us.convert")
    assert reader.read(context()) == pytest.approx((2 + 3) * 1000 / 4)
    assert reader.read(context(trace=False)) is None


def test_midi_in_us_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda start_ns=0, end_ns=None: [])
    assert harness.Cell.reader("midi_in_us.convert").read(context()) is None


@pytest.mark.parametrize("native,python,want", [(0, 0, None), (30, 0, 100.0),
                                                (3, 1, 75.0), (0, 5, 0.0)])
def test_midi_in_native_share_reads_the_counters(monkeypatch, native, python, want):
    monkeypatch.setattr(service.tokens_from_midi, "native_files", native)
    monkeypatch.setattr(service.tokens_from_midi, "python_files", python)
    got = harness.Cell.reader("midi_in_native_share.convert").read(context())
    assert got == (None if want is None else pytest.approx(want))


def test_midi_in_native_share_without_counters_reads_nothing(monkeypatch):
    monkeypatch.delattr(service.tokens_from_midi, "native_files")
    monkeypatch.delattr(service.tokens_from_midi, "python_files")
    assert harness.Cell.reader("midi_in_native_share.convert").read(context()) is None
