"""PyTorch port, the rest of the canonical path against the JAX package (CPU):

- sampled decode held in distribution: ``inference.quality.transfer_stats``
  of the port against the JAX package's, on the shipped ``models/guitar_bass``
  at float32, over 128 corpus rows (shuffled with seed 7) x 2 classes;
- ``cli.evaluate``'s metrics against the JAX ``evaluate`` on the shipped
  model and the whole corpus;
- beam search against the JAX ``beam_search`` on the shipped weights;
- ``cli.main --toy`` and ``cli.sample --toy``;
- the cross-entropy trajectory of one epoch of ``scripts/train-vae.sh``'s
  recipe against the JAX package's train step from the same parameters;
- the in-place step body (device step count, KL weight computed on the
  device, metric sums in place) against the functional ``train_step``, and
  across an optimizer ``load_state_dict`` resume.

Each test states its tolerance. The file takes about a minute on two CPU threads.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from musicstyletransfer_tpu.cli.evaluate import evaluate as jax_evaluate
from musicstyletransfer_tpu.data import Loader as JaxLoader
from musicstyletransfer_tpu.data import MelodyDataset as JaxMelodyDataset
from musicstyletransfer_tpu.inference import decode as jax_decode
from musicstyletransfer_tpu.inference import quality as jax_quality
from musicstyletransfer_tpu.inference.quality import transfer_stats as jax_transfer_stats
from musicstyletransfer_tpu import models as jax_models
from musicstyletransfer_tpu.models import Config, make_model
from musicstyletransfer_tpu.training.optimizer import OptimizerConfig as JaxOptimizerConfig
from musicstyletransfer_tpu.training.optimizer import build_optimizer
from musicstyletransfer_tpu.training.train_step import LossConfig as JaxLossConfig
from musicstyletransfer_tpu.training.train_step import create_train_state, make_train_step
from musicstyletransfer_torch.cli import evaluate as cli_evaluate
from musicstyletransfer_torch.cli import main as cli_main
from musicstyletransfer_torch.cli import sample as cli_sample
from musicstyletransfer_torch.cli.flags import get_config
from musicstyletransfer_torch.convert import load_npz, params_from_jax
from musicstyletransfer_torch.data import Loader, MelodyDataset
from musicstyletransfer_torch.data.prefetch import PrefetchingDataset, prefetch_batches
from musicstyletransfer_torch.inference import decode
from musicstyletransfer_torch.inference import quality
from musicstyletransfer_torch.inference.quality import transfer_stats
from musicstyletransfer_torch.inference.sampler import get_sampler, load_inference_model
from musicstyletransfer_torch.midi import smf
from musicstyletransfer_torch.models import (DecoderConfig, EncoderConfig, ModelConfig,
                                             StyleVAE, TransformerConfig)
from musicstyletransfer_torch.models.vae import init_params
from musicstyletransfer_torch.training.optimizer import Optimizer, OptimizerConfig
from musicstyletransfer_torch.training.train_step import (LossConfig, TrainState, metric_names,
                                                          step_body, train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "models", "guitar_bass")
CORPUS = os.path.join(REPO, "work", "data", "guitar_bass")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shipped():
    """The shipped model at float32: (JAX model, JAX params, port model)."""
    cfg = Config.load(os.path.join(MODEL, "config")).copy(dtype="float32")
    jparams = traverse_util.unflatten_dict({
        tuple(k.split("/")): jnp.asarray(v)
        for k, v in load_npz(os.path.join(MODEL, "torch", "params.npz")).items()})
    exported = load_inference_model(MODEL, -1, torch.device("cpu"))
    model = StyleVAE(dataclasses.replace(exported.config, dtype="float32"))
    model.load_state_dict(exported.state_dict())
    return make_model(cfg), jparams, model.eval()


# transfer_stats' keys compared with the JAX package's
STATS = ("termination_rate", "mean_generated_len", "pitch_js_to_target_class",
         "pitch_js_to_source_mix", "pitch_js_to_own_source", "pitch_js_to_shuffled_source",
         "octave_js_to_target_class", "octave_js_to_other_classes")


def test_sampled_decode_in_distribution(shipped, monkeypatch):
    """The port's sampled transfers of 128 rows (16 a batch, 8 batches,
    shuffled with seed 7) into both classes against the JAX package's XLA
    decode loop (``use_fused=False``) on the same rows, as
    ``transfer_stats`` sees them. Sampling differs from seed to seed, so the
    tolerance of each statistic is 4 x the spread between two JAX seeds,
    the spread floored at one sequence in 256 for the termination rate
    (both seeds may end every row). Also the shipped model's content pin
    (tests/test_pretrained.py: own-source JS < 0.25 and 0.02 below the
    rotated-source null) on the port."""
    jmodel, jparams, model = shipped
    monkeypatch.setattr(jax_decode, "sample_sequences",
                        functools.partial(jax_decode.sample_sequences, use_fused=False))
    jloader = JaxLoader(CORPUS, 64)
    jax_runs = [jax_transfer_stats(jmodel, jparams,
                                   JaxMelodyDataset(16, 64, jloader.melodies, shuffle=True,
                                                    seed=7), 2, max_batches=8, seed=s)
                for s in (0, 1)]
    ours = transfer_stats(model, MelodyDataset(16, 64, Loader(CORPUS, 64).melodies,
                                               shuffle=True, seed=7), 2, max_batches=8, seed=0)
    assert ours["transfer_sequences"] == jax_runs[0]["transfer_sequences"] == 256
    for k in STATS:
        a, b = jax_runs[0][k], jax_runs[1][k]
        spread = max(abs(a - b), 1 / 256 if k == "termination_rate" else 0.0)
        assert abs(ours[k] - (a + b) / 2) <= 4 * spread, (k, ours[k], a, b)
    own, null = ours["pitch_js_to_own_source"], ours["pitch_js_to_shuffled_source"]
    assert own < 0.25 and own < null - 0.02, (own, null)


def test_quality_helpers_match_jax():
    """The port's copies of the numpy helpers and of
    ``class_conditional_stats`` give the JAX module's numbers exactly (the
    same numpy arithmetic) on random token rows of three classes."""
    rng = np.random.default_rng(8)
    rows = {c: [rng.integers(0, 293, rng.integers(0, 40)) for _ in range(5)] for c in range(3)}
    corpus = {c: [rng.integers(0, 293, 30) for _ in range(4)] for c in range(3)}
    for name in ("pitch_class_histogram", "octave_histogram"):
        for r in rows.values():
            np.testing.assert_array_equal(getattr(quality, name)(r),
                                          getattr(jax_quality, name)(r))
    p, q = rng.random(12), rng.random(12)
    assert quality.js_divergence(p, q) == jax_quality.js_divergence(p, q)
    assert (quality.class_conditional_stats(rows, corpus)
            == jax_quality.class_conditional_stats(rows, corpus))


def test_evaluate_matches_jax(shipped, capsys):
    """``cli.evaluate``'s metric pass on the whole corpus (28 batches of 32,
    corpus order) against the JAX ``evaluate``, float32 on both sides:
    relative 1e-4 (float32 sums in another order); then the CLI prints
    the same keys as one JSON line."""
    jmodel, jparams, model = shipped
    want = jax_evaluate(jmodel, jparams,
                        JaxMelodyDataset(32, 64, JaxLoader(CORPUS, 64).melodies, shuffle=False),
                        kl_weight=0.5)
    got = cli_evaluate.evaluate(
        model, MelodyDataset(32, 64, Loader(CORPUS, 64).melodies, shuffle=False),
        kl_weight=0.5)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-4), k
    cli_evaluate.main(["--model-output", MODEL, "--data", CORPUS, "--cpu", "--batch-size", "64",
                       "--max-seq-len", "16"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == set(want) and all(np.isfinite(v) for v in line.values())


@pytest.mark.parametrize("length_penalty", [0.0, 0.6])
def test_beam_search_matches_jax(shipped, length_penalty):
    """Beam search (K=4) of 8 corpus rows (L=16, max_len 34) into the other
    class, float32 on both sides: the same tokens, scores to relative 1e-4
    (float32 log-softmax sums in another order)."""
    jmodel, jparams, model = shipped
    loader = Loader(CORPUS, 16)
    b = next(iter(MelodyDataset(8, 16, loader.melodies)))
    classes = 1 - b.classes
    jseqs, jscores = jax_decode.beam_search(
        jmodel, jparams, jnp.asarray(b.tokens), jnp.asarray(b.seq_lens), jnp.asarray(classes),
        34, 4, length_penalty)
    seqs, scores = decode.beam_search(
        model, *(torch.as_tensor(np.asarray(x)).long() for x in (b.tokens, b.seq_lens, classes)),
        34, 4, length_penalty)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(jseqs))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=1e-4)


def test_beam_search_sampler_writes_every_class(shipped, tmp_path):
    """``get_sampler("beam-search")`` transfers a batch into each class
    (one beam search a class) and writes MIDI that parses back."""
    _, _, model = shipped
    args = get_config(["--sampling-type", "beam-search", "--beam-size", "3"])
    sampler = get_sampler("beam-search", None, None, args, model=model)
    b = next(iter(MelodyDataset(4, 8, Loader(CORPUS, 8).melodies)))
    seqs = sampler.sample_all_classes(b, 2)
    assert seqs.shape == (2, 4, 18)  # max_len twice the 9 source positions
    want, _ = decode.beam_search(model, *(torch.as_tensor(np.asarray(x)).long() for x in (
        b.tokens, b.seq_lens, np.ones_like(b.classes))), 18, 3)
    np.testing.assert_array_equal(seqs[1], want.numpy())
    sampler.process_batch(b, str(tmp_path), 2)
    assert len(os.listdir(tmp_path)) == 3 * 4
    for name in os.listdir(tmp_path):
        smf.read_midifile(str(tmp_path / name))


def test_toy_trains_and_samples(tmp_path):
    """``cli.main --toy``'s ``main_toy`` for 300 epochs (300 steps of the
    toy model on ToyData's 3 rows) into tmp_path overfits the toy data: its
    validation pass (on the same rows) predicts every token (accuracy 1,
    CE below 0.1; the JAX package's toy run is the reference's smoke test).
    Then ``cli.sample --toy``'s ``sample_toy`` on it: 3 originals plus 3
    rows x 3 classes of MIDI."""
    folder = str(tmp_path / "toy" / "model")
    cli_main.main_toy(get_config(["--cpu"]), epochs=300, model_folder=folder)
    assert sorted(os.listdir(folder)) == ["log", "params.1.pt", "torch", "train_state.json"]
    with open(os.path.join(folder, "train_state.json")) as f:
        assert json.load(f)["n_batches"] == 300
    with open(os.path.join(folder, "log", "scalars.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    ce = [x["ce_loss"] for x in lines if "ce_loss" in x]
    assert ce == sorted(ce, reverse=True) and len(ce) == 6  # logged every 50 steps
    final = next(x for x in lines if "validation_acc" in x)
    assert final["validation_acc"] == 1.0 and final["validation_ce_loss"] < 0.1
    out = str(tmp_path / "samples")
    cli_sample.sample_toy(get_config(["--cpu", "--out-samples", out]), model_folder=folder)
    names = sorted(os.listdir(out))
    assert len(names) == 3 + 3 * 3
    for name in names:
        smf.read_midifile(os.path.join(out, name))


def test_canonical_ce_trajectory_matches_jax():
    """One epoch (28 steps) of scripts/train-vae.sh's recipe on the corpus
    (its widths, batch 32, L=64, dropout 0.2, Adam with clip 1.0, KL anneal
    2000, free bits 0.1; float32), from the same initial parameters on the
    same batches: the port's ``train_step`` against the JAX package's train
    step. Dropout and the reparameterisation draw other numbers on each
    side, so the mean cross-entropy of each window of 7 steps is held to the
    mean of two JAX runs (two random keys) within 3 x the two runs' spread;
    and the loss falls by more than 1 nat from the first window to the
    last."""
    def tc(size, layers):
        return jax_models.TransformerConfig(model_size=size, num_layers=layers, num_heads=8,
                                            dropout=0.2, vocab_size=293)

    cfg = jax_models.ModelConfig(
        encoder_config=jax_models.EncoderConfig(transformer_config=tc(256, 2), latent_dim=256),
        decoder_config=jax_models.DecoderConfig(transformer_config=tc(128, 1), latent_dim=256),
        dtype="float32")
    jmodel = make_model(cfg)
    jparams = jax_models.init_params(jmodel, jax.random.key(0), max_seq_len=64)
    batches = list(MelodyDataset(32, 64, Loader(CORPUS, 64).melodies, shuffle=True, seed=0))
    assert len(batches) == 28
    tx = build_optimizer(JaxOptimizerConfig("adam", "clip_gradient:1.0", 3e-4))
    jstep = make_train_step(jmodel, tx, JaxLossConfig(kl_weight=1.0, kl_anneal_steps=2000,
                                                      free_bits=0.1))
    runs = []
    for key in (1, 2):
        state = create_train_state(jparams, tx, jax.random.key(key, impl="threefry2x32"))
        ce = []
        for b in batches:
            state, metrics = jstep(state, None, *map(jnp.asarray, (b.tokens, b.seq_lens,
                                                                   b.classes, b.labels)))
            ce.append(float(metrics["ce_loss"][0]))
        runs.append(ce)

    model = StyleVAE(ModelConfig.from_dict(dataclasses.asdict(cfg)))
    model.load_state_dict(params_from_jax(traverse_util.flatten_dict(jax.device_get(jparams),
                                                                     sep="/")))
    opt = Optimizer(list(model.parameters()), OptimizerConfig("adam", "clip_gradient:1.0", 3e-4))
    loss = LossConfig(kl_weight=1.0, kl_anneal_steps=2000, free_bits=0.1)
    gen = torch.Generator().manual_seed(0)
    ours = []
    for i, b in enumerate(batches):
        acc = train_step(model, opt, loss, i, None, *(torch.as_tensor(np.asarray(x)).long()
                                                      for x in (b.tokens, b.seq_lens, b.classes,
                                                                b.labels)), generator=gen)
        ours.append(float(acc["ce_loss"][0]))
    windows = [slice(7 * w, 7 * w + 7) for w in range(4)]
    for w in windows:
        a, b, c = (float(np.mean(x[w])) for x in (*runs, ours))
        assert abs(c - (a + b) / 2) <= 3 * abs(a - b), (w, c, a, b)
    assert np.mean(ours[windows[0]]) - np.mean(ours[windows[-1]]) > 1.0


def small_model():
    def tc(size):
        return TransformerConfig(model_size=size, num_layers=1, num_heads=2, dropout=0.1,
                                 vocab_size=293)

    cfg = ModelConfig(encoder_config=EncoderConfig(transformer_config=tc(32), latent_dim=8),
                      decoder_config=DecoderConfig(transformer_config=tc(16), latent_dim=8),
                      dtype="float32")
    return init_params(StyleVAE(cfg), 3)


def corpus_batches(n):
    return [tuple(torch.as_tensor(np.asarray(a)).long()
                  for a in (b.tokens, b.seq_lens, b.classes, b.labels))
            for b in list(MelodyDataset(4, 12, Loader(CORPUS, 12).melodies))[:n]]


def test_in_place_step_body_equals_train_step():
    """Five steps of ``step_body`` on one ``TrainState`` (its step count on
    the device, the KL anneal's weight computed from it, metric sums in
    place) against five functional ``train_step`` calls from the same
    model, optimizer (accumulating 2 steps, non-finite guard) and dropout
    generator: parameters, optimizer state, metric sums and the generator
    bit for bit. The in-place run is resumed after its 3rd step into a
    fresh model and optimizer (``load_state_dict`` copies into the new
    optimizer's own tensors)."""
    config = OptimizerConfig("adam", "clip_gradient:1.0,warmup_steps:2,skip_nonfinite:2", 1e-2)
    loss = LossConfig(kl_weight=0.7, kl_anneal_steps=3, free_bits=0.05)
    batches = corpus_batches(5)

    ref = small_model()
    ref_opt = Optimizer(list(ref.parameters()), config, accumulate_steps=2)
    ref_gen = torch.Generator().manual_seed(1)
    acc = None
    for i, b in enumerate(batches):
        acc = train_step(ref, ref_opt, loss, i, acc, *b, generator=ref_gen)

    model = small_model()
    opt = Optimizer(list(model.parameters()), config, accumulate_steps=2)
    gen = torch.Generator().manual_seed(1)
    state = TrainState(metric_names(model), "cpu")
    for b in batches[:3]:
        step_body(model, opt, loss, state, *b, generator=gen)
    saved = (opt.flat.clone(), {k: v.clone() for k, v in opt.state_dict().items()},
             int(state.step), gen.get_state())

    model = small_model()
    opt = Optimizer(list(model.parameters()), config, accumulate_steps=2)
    tensors = dict(opt.state)
    opt.load_state_dict(saved[1])
    with torch.no_grad():
        opt.flat.copy_(saved[0])
    assert all(opt.state[k] is v for k, v in tensors.items())
    gen = torch.Generator().manual_seed(5)
    gen.set_state(saved[3])
    sums, counts = state.sums.clone(), state.counts.clone()
    state = TrainState(metric_names(model), "cpu", step=saved[2])
    state.sums += sums
    state.counts += counts
    for b in batches[3:]:
        step_body(model, opt, loss, state, *b, generator=gen)

    assert int(state.step) == 5
    assert torch.equal(opt.flat, ref_opt.flat)
    for k, v in ref_opt.state.items():
        assert torch.equal(opt.state[k], v), k
    for k, (s, c) in state.metrics().items():
        assert torch.equal(s, acc[k][0]) and torch.equal(c, acc[k][1]), k
    assert torch.equal(gen.get_state(), ref_gen.get_state())


def test_kl_weight_on_the_device_matches_the_host():
    """The anneal's weight from a device step count equals the JAX
    package's float32 arithmetic (kl_weight * min(step / anneal, 1))."""
    cfg = LossConfig(kl_weight=0.3, kl_anneal_steps=7)
    for step in (0, 1, 3, 7, 9):
        want = np.float32(0.3) * np.minimum(np.float32(step) / np.float32(7), np.float32(1))
        got = cfg.kl_weight_at(torch.tensor(step))
        assert got.dtype == torch.float32 and float(got) == float(want), step
    assert LossConfig(kl_weight=0.3).kl_weight_at(torch.tensor(4)) == 0.3


class TestPrefetch:
    """``data/prefetch.py`` (the JAX package's ``prefetch_batches`` and
    ``PrefetchingDataset``) on the CPU."""

    def test_yields_the_batches_as_tensors_in_order(self):
        ds = MelodyDataset(4, 12, Loader(CORPUS, 12).melodies, shuffle=False)
        got = list(PrefetchingDataset(ds, 2))
        want = list(ds)
        assert len(got) == len(want) and got[0].batch.num_valid == want[0].num_valid
        for g, w in zip(got, want):
            assert g.batch is not None
            for t, a in zip(g.tensors, (w.tokens, w.seq_lens, w.classes, w.labels)):
                assert t.dtype == torch.int64 and np.array_equal(t.numpy(), a)
        assert PrefetchingDataset(ds, 2).num_classes() == ds.num_classes()

    def test_a_producer_error_raises_in_the_consumer(self):
        def broken():
            yield next(iter(MelodyDataset(4, 12, Loader(CORPUS, 12).melodies)))
            raise OSError("corpus went away")

        it = prefetch_batches(broken(), 2)
        next(it)
        with pytest.raises(OSError, match="corpus went away"):
            next(it)

    def test_an_abandoned_consumer_stops_the_producer(self):
        import threading

        before = threading.active_count()
        batch = next(iter(MelodyDataset(4, 12, Loader(CORPUS, 12).melodies)))
        endless = iter(lambda: batch, None)
        it = prefetch_batches(endless, 2)
        next(it)
        it.close()
        assert threading.active_count() == before
