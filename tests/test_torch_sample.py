"""PyTorch port, the slice end to end: ``musicstyletransfer_torch.cli.sample``
on a small corpus, the samplers, device resolution, and the port's greedy
transfer against the JAX package's on the same batch (CPU, float32: equal
tokens; scores to relative 1e-4, float32 summation order)."""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from musicstyletransfer_tpu.cli.flags import get_config
from musicstyletransfer_tpu.data import Loader, MelodyDataset
from musicstyletransfer_tpu.inference.decode import sample_sequences as jax_sample_sequences
from musicstyletransfer_tpu.midi import smf
from musicstyletransfer_tpu.midi.codec import tokenize_track
from musicstyletransfer_tpu.midi.vocab import EOS_ID, PAD_ID, SOS_ID
from musicstyletransfer_tpu.models import Config, make_model
from musicstyletransfer_torch.cli import sample as cli_sample
from musicstyletransfer_torch.convert import load_npz
from musicstyletransfer_torch.inference import decode
from musicstyletransfer_torch.inference.sampler import get_sampler, load_inference_model
from musicstyletransfer_torch.models import StyleVAE
from musicstyletransfer_torch.utils import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "models", "guitar_bass")
CORPUS = os.path.join(REPO, "work", "data", "guitar_bass")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; torch's default of one
    thread per core oversubscribes it, and its spin-waiting threads then
    slow every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_corpus(tmp_path_factory):
    """One guitar and one bass file of the bundled corpus (two short ones:
    one batch of 8, so the CPU decode stays quick)."""
    root = tmp_path_factory.mktemp("corpus")
    for cls, name in [("bass", "Until_It_Sleeps_2_Bass-Guitar.mid"),
                      ("guitar", "Metal_Militia_Guitar-3.mid")]:
        os.makedirs(root / cls)
        shutil.copy(os.path.join(CORPUS, cls, name), root / cls / name)
    return str(root)


def corpus_batch(max_seq_len):
    """The first batch of 8 from the whole bundled corpus."""
    loader = Loader(path=CORPUS, max_sequence_length=max_seq_len)
    return next(iter(MelodyDataset(8, loader.max_sequence_length, loader.melodies)))


@pytest.fixture(scope="module")
def first_batch():
    return corpus_batch(64)


@pytest.fixture(scope="module")
def short_batch():
    """L=16 (max_len 34) keeps the bf16 CPU decodes of the sampler tests short."""
    return corpus_batch(16)


def as_long(x):
    return torch.as_tensor(np.asarray(x)).long()


def test_cli_writes_midi_that_parses_back(small_corpus, tmp_path):
    out = tmp_path / "out"
    cli_sample.main(["--model-output", MODEL, "--checkpoint", "-1", "--data", small_corpus,
                     "--out-samples", str(out), "--batch-size", "8", "--cpu"])
    loader = Loader(path=small_corpus, max_sequence_length=64)
    n = MelodyDataset(8, 64, loader.melodies).num_batches() * 8
    expected = {f"out-{i}.{kind}.mid" for i in range(n)
                for kind in ("original", "class-0", "class-1")}
    assert set(os.listdir(out)) == expected
    for name in expected:
        tracks = smf.read_midifile(str(out / name)).tracks
        toks = np.concatenate([tokenize_track(t) for t in tracks])
        assert (toks >= 3).all() and (toks < 293).all(), name


def test_greedy_transfer_matches_jax_float32(first_batch):
    """Same batch, shipped weights at float32 on both sides: the port's
    greedy style transfer emits the JAX package's tokens."""
    b = first_batch
    cfg = Config.load(os.path.join(MODEL, "config")).copy(dtype="float32")
    jparams = traverse_util.unflatten_dict({
        tuple(k.split("/")): jnp.asarray(v)
        for k, v in load_npz(os.path.join(MODEL, "torch", "params.npz")).items()})
    T = 2 * b.tokens.shape[1]
    classes = 1 - b.classes  # the class swap
    jseqs, jscores = jax_sample_sequences(
        make_model(cfg), jparams, jnp.asarray(b.tokens), jnp.asarray(b.seq_lens),
        jnp.asarray(classes), T, jax.random.key(0), greedy=True, use_fused=False)
    shipped = load_inference_model(MODEL, -1, torch.device("cpu"))
    model = StyleVAE(dataclasses.replace(shipped.config, dtype="float32"))
    model.load_state_dict(shipped.state_dict())
    tseqs, tscores = decode.sample_sequences(
        model.eval(), as_long(b.tokens), as_long(b.seq_lens), as_long(classes), T, 0,
        greedy=True)
    np.testing.assert_array_equal(tseqs.numpy(), np.asarray(jseqs))
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores), rtol=1e-4)


class TestSampling:
    @pytest.fixture(scope="class")
    def model(self):
        return load_inference_model(MODEL, -1, torch.device("cpu"))

    def test_style_transfer_all_classes_invariants(self, model, short_batch):
        b = short_batch
        T = 2 * b.tokens.shape[1]
        seqs, scores = decode.style_transfer_all_classes(
            model, as_long(b.tokens), as_long(b.seq_lens), T, 2, seed=5, top_k=40,
            top_p=0.95)
        s = seqs.numpy()
        assert s.shape == (2, 8, T) and scores.shape == (2, 8)
        assert (s[..., 0] == SOS_ID).all() and ((s >= 0) & (s < 293)).all()
        assert bool(torch.isfinite(scores).all()) and bool((scores > 0).all())
        for row in s.reshape(-1, T):
            eos = np.flatnonzero(row == EOS_ID)
            if len(eos):
                assert (row[eos[0] + 1:] == PAD_ID).all()
            assert (row[1:(eos[0] if len(eos) else T)] != PAD_ID).all()

    def test_same_seed_same_samples(self, short_batch):
        args = get_config(["--seed", "3", "--temperature", "0.9"])
        first = get_sampler("sampling", MODEL, -1, args, torch.device("cpu"))
        a = first.sample_all_classes(short_batch, 2)
        b = get_sampler("sampling", MODEL, -1, args,
                        torch.device("cpu")).sample_all_classes(short_batch, 2)
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, first.sample_all_classes(short_batch, 2))

    def test_sample_one_batch(self, short_batch):
        """Sampling.sample transfers a batch into its own classes: [B, T]."""
        sampler = get_sampler("sampling", MODEL, -1, get_config(["--top-k", "10"]),
                              torch.device("cpu"))
        seqs = sampler.sample(short_batch)
        assert seqs.shape == (8, 2 * short_batch.tokens.shape[1])
        assert (seqs[:, 0] == SOS_ID).all() and ((seqs >= 0) & (seqs < 293)).all()

    def test_beam_search_sampler_and_unknown_type(self, model, short_batch):
        """get_sampler("beam-search") decodes by beam search (the shipped
        model, bf16, K=2, L=16: [2, 8, 34]); an unknown type raises."""
        sampler = get_sampler("beam-search", None, None,
                              get_config(["--beam-size", "2", "--length-penalty", "0.6"]),
                              model=model)
        assert (sampler.beam_size, sampler.length_penalty) == (2, 0.6)
        seqs = sampler.sample_all_classes(short_batch, 2)
        assert seqs.shape == (2, 8, 34)
        assert (seqs[..., 0] == SOS_ID).all() and ((seqs >= 0) & (seqs < 293)).all()
        with pytest.raises(ValueError):
            get_sampler("nope", MODEL, -1, get_config([]))


class TestDevice:
    def test_cpu_and_default(self, monkeypatch):
        """No flag means CUDA (raising without a card); --cpu means the CPU."""
        assert resolve_device(cpu=True) == torch.device("cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="--cpu"):
            resolve_device()
        with pytest.raises(RuntimeError, match="--cpu"):
            cli_sample.main(["--model-output", MODEL, "--data", CORPUS,
                             "--out-samples", "unused"])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert resolve_device() == torch.device("cuda")
        assert resolve_device(gpu=True) == torch.device("cuda")

    def test_gpu_without_cuda_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(gpu=True)
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_sample.main(["--model-output", MODEL, "--data", CORPUS,
                             "--out-samples", "unused", "--gpu"])

    def test_both_flags_rejected(self):
        with pytest.raises(ValueError):
            resolve_device(gpu=True, cpu=True)

    @pytest.mark.parametrize("argv", [["--data", CORPUS]])
    def test_cli_refuses(self, argv):
        with pytest.raises(SystemExit):
            cli_sample.main(argv)

    def test_cli_toy_runs(self, tmp_path, monkeypatch):
        """``cli.sample --toy`` transfers ToyData with the toy model that
        ``cli.main --toy`` trained (its folder moved into tmp_path): 3
        originals and 3 rows x 3 classes."""
        from musicstyletransfer_torch.cli import main as cli_main

        folder = str(tmp_path / "toy" / "model")
        monkeypatch.setattr(cli_main, "TOY_MODEL", folder)
        monkeypatch.setattr(cli_sample, "TOY_MODEL", folder)
        cli_main.main_toy(get_config(["--cpu"]), epochs=3, model_folder=folder)
        cli_sample.main(["--toy", "--cpu", "-o", str(tmp_path / "out")])
        assert len(os.listdir(tmp_path / "out")) == 3 + 3 * 3
