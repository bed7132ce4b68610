"""PyTorch port, the legacy LSTM decoder (``--decoder-type lstm``) against
the JAX package on the same weights and inputs (CPU, float32 unless stated):

- ``LSTMCell`` against flax ``OptimizedLSTMCell`` and ``run_lstm`` against
  ``nn.RNN``: 1e-5 (bfloat16: 2e-2, two bf16 ulps of values O(1));
- ``LSTMDecoder.forward`` against the JAX ``LSTMDecoder``: 1e-4, and
  ``step_token`` against ``forward`` step by step: 1e-5;
- the LSTM VAE's ``vae_loss`` and every gradient: 1e-4;
- greedy decode against the JAX XLA loop: tokens identical, scores 1e-4;
  forced decode against the JAX teacher-forced logits: 1e-4;
- beam search: tokens identical, scores relative 1e-4;
- sampled decode in distribution against the JAX XLA loop: ``transfer_stats``
  over 128 corpus rows x 2 classes, three seeds a side, each statistic's
  means within 4 standard errors of their difference (as
  ``test_torch_streaming_stats.py``);
- the converter both ways, a toy overfit, ``main_toy`` with an LSTM toy,
  ``cli.main --decoder-type lstm``
  with ``cli.sample`` (sampling, beam search) and ``cli.evaluate`` on its
  folder, the service, and the refusals (per_step, the streaming engine).
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
from flax import linen as fnn
from flax import traverse_util

from musicstyletransfer_tpu import models as jax_models
from musicstyletransfer_tpu.data import Loader as JaxLoader
from musicstyletransfer_tpu.data import MelodyDataset as JaxMelodyDataset
from musicstyletransfer_tpu.inference import decode as jax_decode
from musicstyletransfer_tpu.inference.quality import transfer_stats as jax_transfer_stats
from musicstyletransfer_tpu.training.loss import vae_loss as jax_vae_loss
from musicstyletransfer_torch.cli import evaluate as cli_evaluate
from musicstyletransfer_torch.cli import main as cli_main
from musicstyletransfer_torch.cli import sample as cli_sample
from musicstyletransfer_torch.cli.flags import get_config
from musicstyletransfer_torch.convert import params_from_jax, params_to_jax
from musicstyletransfer_torch.data import Loader, MelodyDataset, ToyData
from musicstyletransfer_torch.inference import decode
from musicstyletransfer_torch.inference.quality import transfer_stats
from musicstyletransfer_torch.inference.service import StyleTransferService
from musicstyletransfer_torch.inference.streaming import StreamingTransferEngine
from musicstyletransfer_torch.midi import smf
from musicstyletransfer_torch.models import ModelConfig, StyleVAE
from musicstyletransfer_torch.models.config import LSTMConfig
from musicstyletransfer_torch.models.lstm import LSTMCell, run_lstm
from musicstyletransfer_torch.models.vae import init_params
from musicstyletransfer_torch.ops import fused_decode as fd
from musicstyletransfer_torch.training.loss import vae_loss
from musicstyletransfer_torch.training.optimizer import Optimizer, OptimizerConfig
from musicstyletransfer_torch.training.train_step import LossConfig, TrainState, step_body

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "work", "data", "guitar_bass")
V = 293


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def lstm_config(dtype="float32", layers=2, hidden=16, dropout=0.0, conditioning="initial"):
    tc = jax_models.TransformerConfig(model_size=16, num_layers=1, num_heads=2, vocab_size=V)
    return jax_models.ModelConfig(
        encoder_config=jax_models.EncoderConfig(transformer_config=tc, latent_dim=8,
                                                input_dim=V),
        decoder_config=jax_models.DecoderConfig(
            transformer_config=tc, latent_dim=8, output_dim=V, decoder_type="lstm",
            class_conditioning=conditioning,
            lstm_config=jax_models.LSTMConfig(n_layers=layers, hidden_dim=hidden,
                                              dropout=dropout)),
        dtype=dtype)


def port_config(cfg) -> ModelConfig:
    return ModelConfig.from_dict(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def pair():
    """(JAX config, model, params, port model) on the same weights; the
    output bias is spread (normal, std 2, numpy seed 3) so the decoders'
    distributions are peaked, as a trained decoder's are."""
    cfg = lstm_config()
    jmodel = jax_models.make_model(cfg)
    params = jax_models.init_params(jmodel, jax.random.key(0), max_seq_len=16)
    flat = traverse_util.flatten_dict(params, sep="/")
    bias = "decoder/output_layer/bias"
    flat[bias] = jnp.asarray(np.random.default_rng(3).normal(0, 2, V), jnp.float32)
    params = traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})
    model = StyleVAE(port_config(cfg))
    model.load_state_dict(params_from_jax(params))
    return cfg, jmodel, params, model.eval()


def corpus_batch(B=8, L=16, seed=0):
    b = next(iter(MelodyDataset(B, L, Loader(CORPUS, L).melodies, shuffle=True, seed=seed)))
    return b


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.asarray(x)).long()


# --------------------------------------------------------------------------
# The cell and the runner


def flax_cell_params(in_features, hidden, seed):
    cell = fnn.OptimizedLSTMCell(hidden)
    carry = (jnp.zeros((1, hidden)), jnp.zeros((1, hidden)))
    return cell.init(jax.random.key(seed), carry, jnp.zeros((1, in_features)))["params"]


def port_cell(params, in_features, hidden, dtype):
    cell = LSTMCell(in_features, hidden, dtype)
    cell.load_state_dict(params_from_jax(params))
    return cell


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_cell_matches_flax(dtype, tol):
    """One step of flax ``OptimizedLSTMCell(dtype=...)`` from a random
    (c, h) (float32, and a bf16 carry at bf16 as the generator and the VAE
    decoder start from) on random inputs: new c and h."""
    rng = np.random.default_rng(0)
    params = flax_cell_params(12, 16, 1)
    jdt = getattr(jnp, dtype)
    x = rng.normal(size=(5, 12)).astype(np.float32)
    c, h = (rng.normal(size=(5, 16)).astype(np.float32) for _ in range(2))
    carry = (jnp.asarray(c, jdt), jnp.asarray(h, jdt))
    (jc, jh), jout = fnn.OptimizedLSTMCell(16, dtype=jdt).apply(
        {"params": params}, carry, jnp.asarray(x))
    tdt = getattr(torch, dtype)
    cell = port_cell(params, 12, 16, tdt)
    with torch.no_grad():
        tc, th = cell((torch.tensor(c).to(tdt), torch.tensor(h).to(tdt)), torch.tensor(x))
    assert tc.dtype == tdt and th.dtype == tdt
    np.testing.assert_allclose(tc.float().numpy(), _np(jc.astype(jnp.float32)), atol=tol)
    np.testing.assert_allclose(th.float().numpy(), _np(jh.astype(jnp.float32)), atol=tol)
    np.testing.assert_array_equal(_np(jout), _np(jh))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_runner_matches_nn_rnn(dtype, tol):
    """``run_lstm`` over 9 steps from float32 zero carries against flax
    ``nn.RNN(OptimizedLSTMCell)`` (the discriminator's layer): every output
    and the last carry; at bf16 the float32 carry keeps the outputs float32,
    as in flax."""
    rng = np.random.default_rng(1)
    params = flax_cell_params(6, 8, 2)
    jdt = getattr(jnp, dtype)
    x = rng.normal(size=(3, 9, 6)).astype(np.float32)
    rnn = fnn.RNN(fnn.OptimizedLSTMCell(8, dtype=jdt), return_carry=True)
    (jc, jh), jout = rnn.apply({"params": {"cell": params}}, jnp.asarray(x))
    tdt = getattr(torch, dtype)
    cell = port_cell(params, 6, 8, tdt)
    zero = torch.zeros(3, 8)
    with torch.no_grad():
        out, (tc, th) = run_lstm(cell, torch.tensor(x), (zero, zero))
    assert out.dtype == torch.float32 and out.shape == (3, 9, 8)
    np.testing.assert_allclose(out.numpy(), _np(jout), atol=tol)
    np.testing.assert_allclose(tc.numpy(), _np(jc), atol=tol)
    np.testing.assert_allclose(th.numpy(), _np(jh), atol=tol)


# --------------------------------------------------------------------------
# The decoder and the VAE


def test_converter_round_trip_and_names(pair):
    """``params_to_jax(params_from_jax(t)) == t`` for the LSTM VAE's tree,
    the decoder's cells under ``decoder/rnn{i}/cell/{ii,...,ho}``."""
    _, _, params, model = pair
    flat = {k: _np(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    back = params_to_jax(model)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert "decoder/rnn1/cell/if/kernel" in back and "decoder/rnn0/cell/hg/bias" in back


def test_forward_matches_jax(pair):
    """Teacher-forced logits of the whole VAE (eval mode, z = mu) on 8
    corpus rows: 1e-4 (float32 sums in another order over 17 recurrent
    steps)."""
    _, jmodel, params, model = pair
    b = corpus_batch()
    jlogits, jmu, _ = jmodel.apply({"params": params}, *map(jnp.asarray, (
        b.tokens, b.seq_lens, b.classes)), train=False)
    with torch.no_grad():
        logits, mu, _ = model(_t(b.tokens), _t(b.seq_lens), _t(b.classes))
    assert logits.shape == (8, 17, V)  # no conditioning position: aligned with the labels
    np.testing.assert_allclose(mu.numpy(), _np(jmu), atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), atol=1e-4)


def test_step_token_matches_forward(pair):
    """``prefill`` + ``step_token`` step by step against ``forward`` (the
    counterpart of ``tests/test_lstm_decoder.py::test_step_matches_scan``)."""
    _, _, _, model = pair
    rng = np.random.default_rng(4)
    tokens = torch.tensor(rng.integers(3, V, (3, 7)))
    z = torch.tensor(rng.normal(size=(3, 8)), dtype=torch.float32)
    classes = torch.tensor([0, 1, 1])
    dec = model.decoder
    with torch.no_grad():
        full = dec(tokens, None, z, classes)
        cache = dec.prefill(z, classes, 7)
        for t in range(7):
            np.testing.assert_allclose(dec.step_token(tokens[:, t], cache, t).numpy(),
                                       full[:, t].numpy(), atol=1e-5, err_msg=f"step {t}")


def test_vae_loss_and_gradients_match_jax(pair):
    """``vae_loss`` (KL weight 0.5, free bits 0.1) of the training-mode
    forward with the same eps, and the gradient of every parameter, against
    ``jax.value_and_grad`` of the JAX package's ``vae_loss``: 1e-4."""
    cfg, jmodel, params, model = pair
    b = corpus_batch(seed=1)
    eps = np.random.default_rng(5).normal(size=(8, 8)).astype(np.float32)

    def jloss(p):
        mu, logvar = jmodel.apply({"params": p}, *map(jnp.asarray, (b.tokens, b.classes)),
                                  False, method=lambda m, t, c, tr: m.encoder(t, c, tr))
        z = mu + jnp.asarray(eps) * jnp.exp(0.5 * logvar)
        logits = jmodel.apply({"params": p}, jnp.asarray(b.tokens), jnp.asarray(b.seq_lens),
                              z, jnp.asarray(b.classes), False,
                              method=lambda m, *a: m.decoder(*a))
        total, _ = jax_vae_loss(logits, jnp.asarray(b.labels), mu, logvar, 0.5,
                                free_bits=0.1)
        return total

    jtotal, jgrads = jax.value_and_grad(jloss)(params)
    model.train()
    try:
        logits, mu, logvar = model(_t(b.tokens), _t(b.seq_lens), _t(b.classes),
                                   eps=torch.tensor(eps))
        total, _ = vae_loss(logits, _t(b.labels), mu, logvar, 0.5, free_bits=0.1)
        model.zero_grad()
        total.backward()
    finally:
        model.eval()
    np.testing.assert_allclose(float(total.detach()), float(jtotal), atol=1e-4)
    want = params_from_jax(jgrads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-4, err_msg=name)
    model.zero_grad()


def test_per_step_conditioning_refused():
    """``class_conditioning="per_step"`` with the LSTM raises the JAX message."""
    with pytest.raises(ValueError, match="per_step' requires the transformer"):
        StyleVAE(port_config(lstm_config(conditioning="per_step")))


# --------------------------------------------------------------------------
# Decoding


def test_greedy_decode_matches_jax_loop(pair):
    """Greedy transfer of 8 corpus rows into the other class at max_len 34:
    the JAX XLA loop (the JAX package never fuses an LSTM) against the
    port's step loop: tokens identical, scores 1e-4; K1 never launched."""
    _, jmodel, params, model = pair
    b = corpus_batch(seed=2)
    classes = 1 - b.classes
    jseqs, jscores = jax_decode.sample_sequences(
        jmodel, params, *map(jnp.asarray, (b.tokens, b.seq_lens, classes)), 34,
        jax.random.key(0), greedy=True)
    launches = fd.fused_decode.launches
    seqs, scores = decode.sample_sequences(model, _t(b.tokens), _t(b.seq_lens), _t(classes),
                                           34, seed=0, greedy=True)
    assert fd.fused_decode.launches == launches
    np.testing.assert_array_equal(seqs.numpy(), _np(jseqs))
    np.testing.assert_allclose(scores.numpy(), _np(jscores), atol=1e-4)


def test_forced_decode_matches_teacher_forcing(pair):
    """``decode_stepwise`` in forced mode: logits at each step t >= 1 equal
    the JAX teacher-forced logits at position t - 1 (1e-4), and the score is
    the sum of the forced tokens' -log p."""
    _, jmodel, params, model = pair
    b = corpus_batch(seed=3)
    jlogits, mu, _ = jmodel.apply({"params": params}, *map(jnp.asarray, (
        b.tokens, b.seq_lens, b.classes)), train=False)
    forced = torch.tensor(np.asarray(b.tokens), dtype=torch.int32)  # SOS + the row
    seqs, scores, logits = decode.decode_stepwise(
        model, torch.tensor(_np(mu)), _t(b.classes), 17, 0, mode="forced",
        forced_tokens=forced)
    np.testing.assert_array_equal(seqs[:, 1:].numpy(), forced[:, 1:].numpy())
    np.testing.assert_allclose(logits[:, 1:].numpy(), _np(jlogits)[:, :16], atol=1e-4)
    jlp = jax.nn.log_softmax(jlogits[:, :16], axis=-1)
    want = -np.take_along_axis(_np(jlp), np.asarray(b.tokens)[:, 1:, None], -1)[..., 0].sum(-1)
    np.testing.assert_allclose(scores.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("length_penalty", [0.0, 0.6])
def test_beam_search_matches_jax(pair, length_penalty):
    """Beam search (K=3) of 6 corpus rows (L=16, max_len 34) into the other
    class, the LSTM's (c, h) carries reordered like a KV cache: tokens
    identical, scores relative 1e-4."""
    _, jmodel, params, model = pair
    b = corpus_batch(B=6, seed=4)
    classes = 1 - b.classes
    jseqs, jscores = jax_decode.beam_search(
        jmodel, params, *map(jnp.asarray, (b.tokens, b.seq_lens, classes)), 34, 3,
        length_penalty)
    seqs, scores = decode.beam_search(model, _t(b.tokens), _t(b.seq_lens), _t(classes), 34, 3,
                                      length_penalty)
    np.testing.assert_array_equal(seqs.numpy(), _np(jseqs))
    np.testing.assert_allclose(scores.numpy(), _np(jscores), rtol=1e-4)


STATS = ("termination_rate", "mean_generated_len", "pitch_js_to_target_class",
         "pitch_js_to_source_mix", "pitch_js_to_own_source", "pitch_js_to_shuffled_source",
         "octave_js_to_target_class", "octave_js_to_other_classes")


def test_sampled_decode_in_distribution(pair, monkeypatch):
    """Sampled transfers of 128 corpus rows (16 a batch, 8 batches, L=16,
    shuffled with seed 7) into both classes: the port's step loop (its
    Philox Gumbel noise) against the JAX XLA loop (``jax.random``), three
    seeds each, as ``transfer_stats`` sees them. Each statistic's means over
    the seeds agree within 4 standard errors of their difference,
    4 * sqrt((s_port^2 + s_jax^2) / 3) with the sample deviations over the
    seeds (the two-sample rule of ``test_torch_streaming_stats``), each
    deviation floored at one sequence in 256 for the termination rate."""
    _, jmodel, params, model = pair
    monkeypatch.setattr(jax_decode, "sample_sequences",
                        functools.partial(jax_decode.sample_sequences, use_fused=False))
    seeds = (0, 1, 2)
    jloader, loader = JaxLoader(CORPUS, 16), Loader(CORPUS, 16)
    runs = {
        "jax": [jax_transfer_stats(jmodel, params,
                                   JaxMelodyDataset(16, 16, jloader.melodies, shuffle=True,
                                                    seed=7), 2, max_batches=8, seed=s)
                for s in seeds],
        "port": [transfer_stats(model, MelodyDataset(16, 16, loader.melodies, shuffle=True,
                                                     seed=7), 2, max_batches=8, seed=s)
                 for s in seeds],
    }
    for r in runs["jax"] + runs["port"]:
        assert r["transfer_sequences"] == 256
    for k in STATS:
        floor = 1 / 256 if k == "termination_rate" else 0.0
        j, p = (np.asarray([r[k] for r in runs[side]]) for side in ("jax", "port"))
        sj, sp = max(j.std(ddof=1), floor), max(p.std(ddof=1), floor)
        tol = 4 * np.sqrt((sj ** 2 + sp ** 2) / len(seeds))
        assert abs(p.mean() - j.mean()) <= tol, (k, p.tolist(), j.tolist())


def test_noise_blocks_equal_the_kernels_noise():
    """``gumbel_steps`` (the step loop's noise, a block of steps at a time)
    equals, bit for bit, the noise of K1's counters (row, step, vocab index,
    0) computed one step at a time, and ``gumbel_noise`` is its one-step
    case."""
    seed, cpu = 0x1234_5678_9ABC, torch.device("cpu")
    block = fd.gumbel_steps(seed, 5, 70, 3, 11, cpu)
    assert block.shape == (70, 3, 11)
    rows, cols = torch.arange(3)[:, None], torch.arange(11)[None, :]
    zero = torch.zeros_like(cols)
    for i in (0, 1, 63, 69):
        bits = fd.philox4x32(rows, zero + 5 + i, cols, zero, seed, seed >> 32)[0]
        want = -torch.log(-torch.log(fd.uniform_from_bits(bits)))
        assert torch.equal(block[i], want), i
        assert torch.equal(fd.gumbel_noise(seed, 5 + i, 3, 11, cpu), want), i


def test_sampling_semantics(pair):
    """The step loop's sampled rows: SOS first, PAD after the first EOS and
    nothing scored there; top-k 1 equals greedy; one seed, the same rows."""
    _, _, _, model = pair
    b = corpus_batch(seed=5)
    args = (_t(b.tokens), _t(b.seq_lens), _t(b.classes), 34)
    seqs, scores = decode.sample_sequences(model, *args, seed=9)
    again, _ = decode.sample_sequences(model, *args, seed=9)
    assert torch.equal(seqs, again)
    assert (seqs[:, 0] == 1).all()
    for row in seqs.numpy():
        eos = np.flatnonzero(row == 2)
        if eos.size:
            assert (row[eos[0] + 1:] == 0).all()
    top1, _ = decode.sample_sequences(model, *args, seed=9, top_k=1)
    greedy, _ = decode.sample_sequences(model, *args, seed=9, greedy=True)
    assert torch.equal(top1, greedy)
    assert torch.isfinite(scores).all() and (scores > 0).all()


# --------------------------------------------------------------------------
# Training and the entry points


def test_toy_overfit():
    """The LSTM VAE (2 x 16) on ToyData, 300 Adam steps (clip 1.0, lr 2e-3,
    KL weight 0.1): the loss falls below half its first value, as
    ``tests/test_lstm_decoder.py::test_toy_overfit`` asks of the JAX one."""
    cfg = dataclasses.replace(lstm_config(), encoder_config=dataclasses.replace(
        lstm_config().encoder_config, input_dim=10, num_classes=3))
    cfg = dataclasses.replace(cfg, decoder_config=dataclasses.replace(
        cfg.decoder_config, output_dim=10, num_classes=3))
    model = init_params(StyleVAE(port_config(cfg)), 0)
    opt = Optimizer(list(model.parameters()), OptimizerConfig("adam", "clip_gradient:1.0", 2e-3))
    state = TrainState(["ppl", "acc", "top5_acc", "ce_loss", "kl_loss", "total_loss",
                        "grad_norm"], "cpu")
    gen = torch.Generator().manual_seed(1)
    b = next(iter(ToyData()))
    tensors = [_t(x) for x in (b.tokens, b.seq_lens, b.classes, b.labels)]
    totals = []
    for _ in range(300):
        state.reset_metrics()
        step_body(model, opt, LossConfig(kl_weight=0.1), state, *tensors, generator=gen)
        totals.append(float(state.sums[5]))
    assert totals[-1] < 0.5 * totals[0], (totals[0], totals[-1])


def test_cli_main_toy_lstm(tmp_path):
    """``cli.main --toy`` ignores ``--decoder-type lstm``, as the JAX toy
    does (one epoch: the export names the transformer); ``main_toy`` with
    the toy config's decoder swapped for a 1 x 32 LSTM (300 epochs) trains
    it and its export names the LSTM."""
    def decoder_config(folder):
        with open(os.path.join(folder, "torch", "config.json")) as f:
            return json.load(f)["model_config"]["decoder_config"]

    args = get_config(["--cpu", "--decoder-type", "lstm"])
    folder = str(tmp_path / "toy")
    cli_main.main_toy(args, epochs=1, model_folder=folder)
    assert decoder_config(folder)["decoder_type"] == "transformer"
    toy = cli_main.create_toy_model_config(ToyData())
    config = dataclasses.replace(toy, decoder_config=dataclasses.replace(
        toy.decoder_config, decoder_type="lstm", lstm_config=LSTMConfig(n_layers=1, hidden_dim=32)))
    folder = str(tmp_path / "toy-lstm")
    cli_main.main_toy(args, epochs=300, model_folder=folder, config=config)
    dc = decoder_config(folder)
    assert dc["decoder_type"] == "lstm" and dc["lstm_config"]["hidden_dim"] == 32


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``cli.main --decoder-type lstm`` for one epoch at tiny widths (L=16,
    batch 16, the decoder 1 x 24 LSTM with dropout 0.2, groups of 4 steps),
    with a checkpoint and the generation-health probe."""
    root = tmp_path_factory.mktemp("lstm")
    folder = str(root / "model")
    cli_main.main([
        "--cpu", "--data", CORPUS, "--model-output", folder, "--logdir", folder + "-log",
        "--batch-size", "16", "--max-seq-len", "16", "--epochs", "1",
        "--e-rnn-hidden-dim", "16", "--e-num-heads", "2", "--latent-dim", "8",
        "--decoder-type", "lstm", "--d-n-layers", "1", "--d-rnn-hidden-dim", "24",
        "--d-dropout", "0.2", "--steps-per-dispatch", "4", "--log-every", "4"])
    return root, folder


def test_cli_main_trains_an_lstm_vae(trained):
    """The run writes params.1.pt, the export (decoder_type "lstm", the
    LSTM's widths from --d-*) and finite logged losses; the health probe ran
    through the step loop (its scalars logged)."""
    _, folder = trained
    with open(os.path.join(folder, "torch", "config.json")) as f:
        dc = json.load(f)["model_config"]["decoder_config"]
    assert dc["decoder_type"] == "lstm"
    assert dc["lstm_config"] == {"n_layers": 1, "hidden_dim": 24, "dropout": 0.2}
    assert "params.1.pt" in os.listdir(folder)
    with open(os.path.join(folder + "-log", "scalars.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    losses = [x["total_loss"] for x in lines if "total_loss" in x]
    assert losses and all(np.isfinite(losses))
    assert any("gen_termination_rate" in x for x in lines)


@pytest.mark.parametrize("kind", ["sampling", "beam-search"])
def test_cli_sample_on_the_lstm_folder(trained, kind):
    """``cli.sample`` (sampling and beam search) reads the LSTM model's
    ``params.1.pt`` and writes originals plus both classes' transfers of two
    batches, which parse back."""
    root, folder = trained
    out = str(root / f"out-{kind}")
    cli_sample.main(["--cpu", "--model-output", folder, "--data", CORPUS, "--out-samples", out,
                     "--batch-size", "64", "--max-seq-len", "16", "--sampling-type", kind,
                     "--beam-size", "2"])
    names = os.listdir(out)
    assert names and len(names) % 3 == 0
    for name in names[:12]:
        smf.read_midifile(os.path.join(out, name))


def test_cli_evaluate_on_the_lstm_folder(trained, capsys):
    """``cli.evaluate --transfer-stats`` on the LSTM folder: one JSON line,
    every metric finite."""
    _, folder = trained
    cli_evaluate.main(["--cpu", "--model-output", folder, "--data", CORPUS, "--max-seq-len", "16",
                       "--batch-size", "32", "--transfer-stats", "--stats-batches", "2"])
    vals = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("ppl", "acc", "total_loss", "termination_rate", "octave_js_to_target_class"):
        assert np.isfinite(vals[k]), k
    assert vals["transfer_sequences"] == 2 * 2 * 32


def test_service_serves_the_lstm_and_the_engine_refuses_it(trained):
    """``StyleTransferService`` on the LSTM folder transfers two corpus
    rows into both classes (MIDI bytes); the streaming
    engine refuses the LSTM with the JAX engine's message."""
    _, folder = trained
    svc = StyleTransferService(folder, batch_size=4, max_seq_len=16, device=torch.device("cpu"))
    rows = [m.tokens for m in Loader(CORPUS, 16).melodies["bass"][:2]]
    results = svc.transfer_tokens(rows)
    assert len(results) == 2
    for r in results:
        for c in range(2):
            toks = r.tokens_by_class[c]
            assert r.midi_by_class[c][:4] == b"MThd" and ((toks >= 0) & (toks < V)).all()
    with pytest.raises(ValueError, match="streaming engine requires the transformer decoder"):
        StreamingTransferEngine(folder, device=torch.device("cpu"))
