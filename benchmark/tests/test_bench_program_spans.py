"""The readers of the program's own spans: microseconds a file or a step of
the spans that started in the traced window, cut at its end, and nothing
without a trace or without spans to read."""

import types

import pytest

from helpers import harness
from musicstyletransfer_torch import tracing

MS = 10**6  # ns
WINDOW = (100 * MS, 200 * MS)


def span(name, start_ms, length_ms):
    start = start_ms * MS
    return tracing.Span(name, start, start + length_ms * MS)


SPANS = [
    span("service.dispatch", 110, 3), span("service.dispatch", 150, 5),
    span("service.detokenize", 115, 2), span("service.midi_write", 118, 4),
    span("service.midi_write", 99, 50),  # started before the window: left out
    span("train.dispatch", 120, 2), span("train.dispatch", 130, 2),
    span("prefetch.stage", 121, 1), span("prefetch.wait", 140, 6),
    span("prefetch.stage", 199, 90),  # cut at the window's end: 1 ms in it
    span("prefetch.wait", 201, 6),  # started after the window: left out
]


def context(trace=True):
    t = types.SimpleNamespace(start_ns=WINDOW[0], end_ns=WINDOW[1]) if trace else None
    return types.SimpleNamespace(trace=t, attempted=4, work={"steps": 8})


@pytest.fixture
def recorded(monkeypatch):
    def spans(start_ns=0, end_ns=None):
        return [s for s in SPANS if start_ns <= s.start_ns <= end_ns]

    monkeypatch.setattr(tracing, "spans", spans)


@pytest.mark.parametrize("metric,want", [
    ("midi_out_us.convert", (2 + 4) * 1000 / 4),
    ("dispatch_us.convert", (3 + 5) * 1000 / 4),
    ("train_dispatch_us.train", (2 + 2) * 1000 / 8),
    ("stage_us.train", (1 + 1) * 1000 / 8),
    ("prefetch_wait_us.train", 6 * 1000 / 8),
])
def test_reader_sums_the_windows_spans(recorded, metric, want):
    reader = harness.Cell.reader(metric)
    assert reader.read(context()) == pytest.approx(want)
    assert reader.read(context(trace=False)) is None


@pytest.mark.parametrize("metric", ["midi_out_us.convert", "dispatch_us.convert",
                                    "train_dispatch_us.train", "stage_us.train",
                                    "prefetch_wait_us.train"])
def test_reader_without_spans_reads_nothing(monkeypatch, metric):
    monkeypatch.setattr(tracing, "spans", lambda start_ns=0, end_ns=None: [])
    assert harness.Cell.reader(metric).read(context()) is None
