"""PyTorch port, ``tracing``: spans record only while a ``torch.profiler``
trace runs in the process, on any thread, on the profiler's clock, and the
convert and train paths record their spans without changing what they
compute. CPU only; the shipped model serves the convert path."""

import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from musicstyletransfer_torch import tracing
from musicstyletransfer_torch.data.dataset import MelodyDataset
from musicstyletransfer_torch.data.loader import Loader
from musicstyletransfer_torch.data.prefetch import prefetch_batches
from musicstyletransfer_torch.inference.service import StyleTransferService, tokens_from_midi
from musicstyletransfer_torch.models import (DecoderConfig, EncoderConfig, ModelConfig,
                                             StyleVAE, TransformerConfig)
from musicstyletransfer_torch.training.trainer import TrainConfig, Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "work", "data", "guitar_bass")
SHIPPED = os.path.join(REPO, "models", "guitar_bass")
CPU = torch.device("cpu")
CONVERT_SPANS = ("service.dispatch", "service.batch", "decode.encode", "decode.k1",
                 "service.finish", "service.copy_back", "service.detokenize",
                 "service.midi_write")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_spans_kept():
    tracing.clear()
    yield
    tracing.clear()


@pytest.fixture
def opened_on(monkeypatch):
    """{span name: the threads that opened it}."""
    seen = {}
    real = tracing.span

    def span(name):
        seen.setdefault(name, set()).add(threading.get_ident())
        return real(name)

    monkeypatch.setattr(tracing, "span", span)
    return seen


def traced():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_a_span_is_one_shared_null_context_and_records_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    first = tracing.span("a")
    assert tracing.span("b") is first
    with first as entered:
        assert entered is None

    def spans(n):
        for _ in range(n):
            with tracing.span("a"):
                pass

    spans(10)
    blocks = sys.getallocatedblocks()
    spans(10000)
    assert sys.getallocatedblocks() - blocks < 100  # nothing kept a span
    assert tracing.spans() == []


def test_nested_spans_threads_and_the_profilers_clock(opened_on):
    def other():
        with tracing.span("other"):
            pass

    with traced() as prof:
        with tracing.span("outer"):
            with tracing.span("inner"):
                pass
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    got = by_name(tracing.spans())
    (outer,), (inner,), (far,) = got["outer"], got["inner"], got["other"]
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    # recorded on the other thread while the main thread's profiler ran
    main = threading.get_ident()
    assert opened_on["outer"] == opened_on["inner"] == {main}
    assert opened_on["other"] == {t.ident} != {main}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ("outer", "inner")}
    for s in (outer, inner):
        e = events[s.name]
        assert s.start_ns - 10**6 <= e.start_ns() <= e.start_ns() + e.duration_ns() \
            <= s.end_ns + 10**6
    start = min(s.start_ns for s in (outer, inner, far))
    assert tracing.spans(start, outer.start_ns) == [outer]  # by their start
    assert tracing.spans(outer.end_ns + 1) == []


def service():
    return StyleTransferService(SHIPPED, checkpoint=-1, batch_size=4, max_seq_len=16,
                                seed=2**32 + 5, device=CPU)


@pytest.fixture(scope="module")
def requests():
    folder = os.path.join(CORPUS, "guitar")
    names = sorted(f for f in os.listdir(folder) if f.endswith(".mid"))[:3]
    return [tokens_from_midi(open(os.path.join(folder, n), "rb").read(), 16) for n in names]


def test_transfer_tokens_records_each_span_once_inside_its_parent(requests):
    quiet, loud = service(), service()
    want = quiet.transfer_tokens(requests)
    with traced():
        got = loud.transfer_tokens(requests)
    for w, g in zip(want, got):
        assert list(w.midi_by_class) == list(g.midi_by_class)
        assert w.midi_by_class == g.midi_by_class
        assert all(np.array_equal(w.tokens_by_class[c], g.tokens_by_class[c])
                   for c in w.tokens_by_class)
    spans = by_name(tracing.spans())
    assert sorted(spans) == sorted(CONVERT_SPANS)
    assert all(len(v) == 1 for v in spans.values())
    s = {k: v[0] for k, v in spans.items()}
    parents = {"service.batch": "service.dispatch", "decode.encode": "service.dispatch",
               "decode.k1": "service.dispatch", "service.copy_back": "service.finish",
               "service.detokenize": "service.finish", "service.midi_write": "service.finish"}
    for child, parent in parents.items():
        c, p = s[child], s[parent]
        assert p.start_ns <= c.start_ns <= c.end_ns <= p.end_ns
    assert s["service.dispatch"].end_ns <= s["service.finish"].start_ns
    assert s["decode.encode"].end_ns <= s["decode.k1"].start_ns
    assert s["service.detokenize"].end_ns <= s["service.midi_write"].start_ns


def small_model():
    def tc(size):
        return TransformerConfig(model_size=size, num_layers=1, num_heads=4, dropout=0.0,
                                 vocab_size=293)

    torch.manual_seed(0)
    return StyleVAE(ModelConfig(
        encoder_config=EncoderConfig(transformer_config=tc(32), latent_dim=8),
        decoder_config=DecoderConfig(transformer_config=tc(16), latent_dim=8),
        dtype="float32"))


def test_train_batches_and_the_prefetch_thread_record_their_spans(tmp_path, opened_on):
    trainer = Trainer(TrainConfig(batch_size=4, logdir=str(tmp_path)), small_model())
    ds = MelodyDataset(4, 12, Loader(CORPUS, 12).melodies, shuffle=False)
    with traced():
        it = prefetch_batches(iter(ds), 2)
        group = [next(it).tensors for _ in range(2)]
        trainer.train_batches(group)
        trainer.train_batches(group[:1])
        it.close()
    spans = by_name(tracing.spans())
    main = threading.get_ident()
    assert len(spans["train.dispatch"]) == 2 and opened_on["train.dispatch"] == {main}
    waits, stages = spans["prefetch.wait"], spans["prefetch.stage"]
    assert len(waits) == 2 and opened_on["prefetch.wait"] == {main}
    assert len(stages) >= 2 and main not in opened_on["prefetch.stage"]
    for w, stage in zip(waits, stages):  # a batch is waited for once it was staged
        assert stage.end_ns <= w.end_ns
