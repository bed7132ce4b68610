"""PyTorch port, the slot-based streaming engine's sampled transfers held in
distribution against the JAX engine's (CPU): ``inference.quality.transfer_stats``
of 128 corpus rows x 2 classes through each engine on the shipped model at
float32, three seeds a side. The tolerance is in the test's docstring.
"""

import dataclasses
import functools
import os
import time

import numpy as np
import pytest
import torch

from musicstyletransfer_tpu.models import Config, make_model
from musicstyletransfer_torch.inference import decode, quality
from musicstyletransfer_torch.inference.streaming import StreamingTransferEngine
from musicstyletransfer_torch.midi.vocab import PAD_ID
from musicstyletransfer_torch.models import StyleVAE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "models", "guitar_bass")
CORPUS = os.path.join(REPO, "work", "data", "guitar_bass")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# transfer_stats' keys compared with the JAX engine's
STATS = ("termination_rate", "mean_generated_len", "pitch_js_to_target_class",
         "pitch_js_to_source_mix", "pitch_js_to_own_source", "pitch_js_to_shuffled_source",
         "octave_js_to_target_class", "octave_js_to_other_classes")


def engine_transfer(eng, tokens, seq_lens, max_len, num_classes):
    """[C, B, max_len] raw token rows of a batch through ``eng`` (either
    package's engine), in the layout of style_transfer_all_classes."""
    tokens, seq_lens = np.asarray(tokens), np.asarray(seq_lens)
    assert max_len == eng.t_gen
    out = {}
    eng._result_of = lambda req: dict(req.results_tokens)
    for i, (row, n) in enumerate(zip(tokens, seq_lens)):
        eng._queue.put((row[1:int(n)], functools.partial(out.__setitem__, i),
                        time.perf_counter()))
    for _ in range(10000):
        if len(out) == len(tokens):
            break
        eng._cycle(block=False)
    seqs = np.full((num_classes, len(tokens), max_len), PAD_ID, np.int32)
    for i, rows in out.items():
        assert not isinstance(rows, Exception), rows
        for c, row in rows.items():
            seqs[c, i] = row
    return seqs


def test_sampled_engine_in_distribution(monkeypatch):
    """Sampled transfers of 128 corpus rows (16 a batch, 8 batches, shuffled
    with seed 7) into both classes through the port's engine and the JAX
    engine, on the shipped model at float32, three seeds each, as
    ``transfer_stats`` sees them. Each statistic's means over the seeds
    agree within 4 standard errors of their difference,
    4 * sqrt((s_port^2 + s_jax^2) / 3) with the sample deviations over the
    seeds (a two-sample test; two seeds' spread alone is too often small by
    chance), each deviation floored at one sequence in 256 for the
    termination rate."""
    from musicstyletransfer_tpu.data import Loader as JaxLoader
    from musicstyletransfer_tpu.data import MelodyDataset as JaxMelodyDataset
    from musicstyletransfer_tpu.inference import decode as jax_decode
    from musicstyletransfer_tpu.inference.quality import transfer_stats as jax_transfer_stats
    from musicstyletransfer_tpu.inference.streaming import (
        StreamingTransferEngine as JaxEngine)
    from musicstyletransfer_torch.data import Loader, MelodyDataset

    kw = dict(slots=32, max_seq_len=64, segment_steps=32)
    seeds = (0, 1, 2)
    jmodel = make_model(Config.load(os.path.join(MODEL, "config")).copy(dtype="float32"))
    jloader, loader = JaxLoader(CORPUS, 64), Loader(CORPUS, 64)
    runs = {"jax": [], "port": []}
    for seed in seeds:
        jeng = JaxEngine(MODEL, -1, seed=seed, harvest_delay_s=0.0, **kw)
        jeng.model = jmodel
        monkeypatch.setattr(
            jax_decode, "style_transfer_all_classes",
            lambda model, params, tokens, seq_lens, max_len, num_classes, rng, eng=jeng:
            (engine_transfer(eng, tokens, seq_lens, max_len, num_classes), None))
        runs["jax"].append(jax_transfer_stats(
            jmodel, jeng.params, JaxMelodyDataset(16, 64, jloader.melodies, shuffle=True, seed=7),
            2, max_batches=8))
        eng = StreamingTransferEngine(MODEL, -1, seed=seed, device=CPU, **kw)
        model = StyleVAE(dataclasses.replace(eng.model.config, dtype="float32"))
        model.load_state_dict(eng.model.state_dict())
        eng.model = model.eval()
        monkeypatch.setattr(
            decode, "style_transfer_all_classes",
            lambda model, tokens, seq_lens, max_len, num_classes, seed, eng=eng:
            (torch.as_tensor(engine_transfer(eng, tokens, seq_lens, max_len, num_classes)), None))
        runs["port"].append(quality.transfer_stats(
            eng.model, MelodyDataset(16, 64, loader.melodies, shuffle=True, seed=7), 2,
            max_batches=8))
    for r in runs["jax"] + runs["port"]:
        assert r["transfer_sequences"] == 256
    for k in STATS:
        floor = 1 / 256 if k == "termination_rate" else 0.0
        j, p = (np.asarray([r[k] for r in runs[side]]) for side in ("jax", "port"))
        sj, sp = max(j.std(ddof=1), floor), max(p.std(ddof=1), floor)
        tol = 4 * np.sqrt((sj ** 2 + sp ** 2) / len(seeds))
        assert abs(p.mean() - j.mean()) <= tol, (k, p.tolist(), j.tolist())
