"""PyTorch port, the training slice against the JAX package (CPU, float32):
the model's logits and every parameter's gradient of ``vae_loss`` with the
attention core engaged, the losses and metrics, the optimizer over six steps
with a non-finite step, one train step and the eval step, and the training
CLI end to end (train, checkpoint, resume, sample).

Tolerances: float32 on both sides, sums in other orders: 1e-4 relative on
logits, losses and gradients (with an absolute 1e-5, times a tensor's
largest gradient where that is above 1: some gradients, such as the key
bias's, are zero up to float32 noise); 1e-5 relative on parameters after
optimizer steps (float32 sums of squares and learning-rate arithmetic in
another order).
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from musicstyletransfer_tpu.models import (
    DecoderConfig,
    EncoderConfig,
    ModelConfig,
    TransformerConfig,
    init_params,
    make_model,
)
from musicstyletransfer_tpu.training import loss as jloss
from musicstyletransfer_tpu.training import metrics as jmetrics
from musicstyletransfer_tpu.training.optimizer import OptimizerConfig as JaxOptimizerConfig
from musicstyletransfer_tpu.training.optimizer import build_optimizer
from musicstyletransfer_tpu.training.train_step import LossConfig as JaxLossConfig
from musicstyletransfer_tpu.training.train_step import make_eval_step
from musicstyletransfer_torch.cli import main as cli_main
from musicstyletransfer_torch.cli import sample as cli_sample
from musicstyletransfer_torch.convert import params_from_jax
from musicstyletransfer_torch.data import layout_chunks
from musicstyletransfer_torch.models import StyleVAE
from musicstyletransfer_torch.models import config as tconfig
from musicstyletransfer_torch.ops import attention_core as ac
from musicstyletransfer_torch.ops import fused_decode as fd
from musicstyletransfer_torch.training import checkpoint as ckpt
from musicstyletransfer_torch.training import loss as tloss
from musicstyletransfer_torch.training import metrics as tmetrics
from musicstyletransfer_torch.training.optimizer import OptimizerConfig, Optimizer
from musicstyletransfer_torch.training.train_step import LossConfig, eval_step, train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "work", "data", "guitar_bass")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_config():
    """A pre-LN model whose every attention takes the attention core."""
    def tc(size, layers):
        return TransformerConfig(model_size=size, num_layers=layers, num_heads=4, dropout=0.0,
                                 vocab_size=293, use_flash_attention=True,
                                 attention_core_min_seq_len=1, norm_scheme="pre")

    return ModelConfig(
        encoder_config=EncoderConfig(transformer_config=tc(64, 2), latent_dim=16),
        decoder_config=DecoderConfig(transformer_config=tc(32, 1), latent_dim=16),
        dtype="float32")


def batch(seed, B=3, L=24):
    rng = np.random.default_rng(seed)
    chunks = np.zeros((B, L), np.int32)
    for b, n in enumerate(rng.integers(3, L + 1, B)):
        chunks[b, :n] = rng.integers(3, 293, n)
    tokens, seq_lens, labels = layout_chunks(chunks)
    classes = rng.integers(0, 2, B).astype(np.int32)
    eps = rng.normal(size=(B, 16)).astype(np.float32)
    return tokens, seq_lens, classes, labels, eps


@pytest.fixture(scope="module")
def both_models():
    cfg = small_config()
    jmodel = make_model(cfg)
    jparams = init_params(jmodel, jax.random.key(0), max_seq_len=24)
    tmodel = StyleVAE(tconfig.ModelConfig.from_dict(dataclasses.asdict(cfg)))
    tmodel.load_state_dict(params_from_jax(jparams))
    return jmodel, jparams, tmodel


def jax_loss(jmodel, tokens, seq_lens, classes, labels, eps, kl_weight, free_bits, smoothing):
    """JAX vae_loss with z = mu + eps * exp(logvar / 2) from the given eps."""
    def f(params):
        mu, logvar = jmodel.apply({"params": params}, tokens, classes, False,
                                  method=lambda m, t, c, tr: m.encoder(t, c, tr))
        z = mu + eps * jnp.exp(0.5 * logvar)
        logits = jmodel.apply({"params": params}, tokens, seq_lens, z, classes, False,
                              method=lambda m, *a: m.decoder(*a))
        total, _ = jloss.vae_loss(logits, labels, mu, logvar, kl_weight,
                                  label_smoothing=smoothing, free_bits=free_bits)
        return total, logits
    return f


@pytest.mark.parametrize("free_bits,smoothing", [(0.0, 0.0), (0.1, 0.1)])
def test_logits_and_gradients_match_jax(both_models, free_bits, smoothing):
    jmodel, jparams, tmodel = both_models
    tokens, seq_lens, classes, labels, eps = batch(1)
    (jtotal, jlogits), jgrads = jax.value_and_grad(
        jax_loss(jmodel, *map(jnp.asarray, (tokens, seq_lens, classes, labels, eps)),
                 0.5, free_bits, smoothing), has_aux=True)(jparams)
    tmodel.train()
    tmodel.zero_grad(set_to_none=True)
    launches = ac.core_forward.launches
    logits, mu, logvar = tmodel(*(torch.as_tensor(x).long() for x in (tokens, seq_lens, classes)),
                                eps=torch.from_numpy(eps))
    total, _ = tloss.vae_loss(logits, torch.as_tensor(labels).long(), mu, logvar, 0.5,
                              label_smoothing=smoothing, free_bits=free_bits)
    total.backward()
    assert ac.core_forward.launches == launches  # the CPU takes the plain versions
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-4)
    want = params_from_jax(jgrads)
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(want) == set(got)
    for name, g in want.items():
        scale = max(float(g.abs().max()), 1.0)
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)


def test_losses_and_metrics_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(4, 9, 293)).astype(np.float32) * 3
    labels = rng.integers(0, 293, (4, 9)).astype(np.int32)
    labels[:, 6:] = 0
    labels[1, 2] = int(np.argmax(logits[1, 2]))  # a hit
    mu = rng.normal(size=(4, 5)).astype(np.float32)
    logvar = rng.normal(size=(4, 5)).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in dict(logits=logits, labels=labels, mu=mu,
                                                 logvar=logvar).items()}
    for smoothing in (0.0, 0.2):
        for norm in ("valid", "length"):
            np.testing.assert_allclose(
                tloss.masked_cross_entropy(t["logits"], t["labels"], smoothing, norm).numpy(),
                np.asarray(jloss.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                                      smoothing, norm)), rtol=1e-5)
    np.testing.assert_allclose(tloss.kl_divergence(t["mu"], t["logvar"]).numpy(),
                               np.asarray(jloss.kl_divergence(mu, logvar)), rtol=1e-5)
    tt, ts = tloss.vae_loss(t["logits"], t["labels"], t["mu"], t["logvar"], 0.3, 0.1, "valid", 0.5)
    jt, js = jloss.vae_loss(logits, labels, mu, logvar, 0.3, 0.1, "valid", 0.5)
    for k in ("ce_loss", "kl_loss", "total_loss"):
        np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=1e-5)
    tm = tmetrics.step_metrics(t["logits"], t["labels"], {})
    jm = jmetrics.step_metrics(jnp.asarray(logits), jnp.asarray(labels), {})
    for k in ("ppl", "acc", "top5_acc"):
        np.testing.assert_allclose(float(tm[k][0]), float(jm[k][0]), rtol=1e-5)
        assert float(tm[k][1]) == float(jm[k][1])
    acc = tmetrics.MetricAccumulator()
    acc.update(tmetrics.accumulate(tmetrics.accumulate({}, tm), tm))
    jacc = jmetrics.MetricAccumulator()
    jacc.update(jax.device_get(jm))
    for k, v in jacc.get().items():
        assert acc.get()[k] == pytest.approx(v, rel=1e-5)


# (optimizer, extras, steps whose gradient holds a NaN, accumulation steps k)
OPT_CASES = {
    "warmup+cosine, one NaN step": ("adam", "clip_gradient:1.0,clip_global_norm:1.0,"
                                    "warmup_steps:2,decay_steps:4,skip_nonfinite:2", [3], 1),
    "gives up after K non-finite steps": ("adam", "clip_gradient:1.0,skip_nonfinite:2",
                                          [1, 2, 3], 1),
    "constant rate, epsilon and betas": ("adam", "beta1:0.8,beta2:0.99,epsilon:1e-6", [], 1),
    "warmup only": ("adam", "warmup_steps:3,clip_global_norm:0.5", [], 1),
    "cosine only": ("adam", "decay_steps:5", [], 1),
    "adam with wd": ("adam", "wd:0.1", [], 1),
    "adamw, default decay": ("adamw", "clip_global_norm:1.0", [], 1),
    "adamw with wd and warmup": ("adamw", "wd:0.05,warmup_steps:2", [], 1),
    "sgd": ("sgd", "", [], 1),
    "sgd with momentum, wd and clip": ("sgd", "momentum:0.9,wd:0.1,clip_gradient:1.0", [], 1),
    "rmsprop": ("rmsprop", "gamma1:0.95,epsilon:1e-6,decay_steps:5", [], 1),
    "MultiSteps k=2, one NaN step": ("adam", "clip_gradient:1.0,skip_nonfinite:2", [2], 2),
    "MultiSteps k=3, one NaN step": ("adam", "warmup_steps:2,skip_nonfinite:3", [1], 3),
    "MultiSteps k=2, sgd with momentum": ("sgd", "momentum:0.5", [], 2),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax(case):
    """Seven steps against build_optimizer's chain (wrapped in
    optax.MultiSteps where k > 1, as the JAX trainer does)."""
    name, extras, nan_steps, k = OPT_CASES[case]
    rng = np.random.default_rng(3)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jparams = {f"p{i}": jnp.asarray(x) for i, x in enumerate(init)}
    tx = build_optimizer(JaxOptimizerConfig(name, extras, 1e-2))
    if k > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=k).gradient_transformation()
    state = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in init]
    opt = Optimizer(tparams, OptimizerConfig(name, extras, 1e-2), accumulate_steps=k)
    for step in range(7):
        grads = [(rng.normal(size=s) * 3).astype(np.float32) for s in shapes]
        if step in nan_steps:
            grads[1][2] = np.nan
        updates, state = tx.update({f"p{i}": jnp.asarray(g) for i, g in enumerate(grads)},
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step(torch.cat([torch.from_numpy(g).reshape(-1) for g in grads]))
        for i, p in enumerate(tparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[f"p{i}"]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"{case}, step {step}")
    if "skip_nonfinite" in extras:
        guard = getattr(state, "inner_opt_state", state)
        assert int(opt.state["total_notfinite"]) == int(guard.total_notfinite)
        # a NaN stays in MultiSteps' running mean: every later k-th step is skipped
        assert int(opt.state["total_notfinite"]) == (len(nan_steps) if k == 1 else 2)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unsupported optimizer 'lamb'"):
        Optimizer([torch.nn.Parameter(torch.zeros(2))], OptimizerConfig("lamb", "", 1e-3))


def test_optimizer_state_loads_in_place():
    """load_state_dict copies into the optimizer's own tensors (a captured
    CUDA graph keeps reading them): the next step equals the uninterrupted
    one bit for bit."""
    rng = np.random.default_rng(4)
    config = OptimizerConfig("adam", "clip_gradient:1.0,skip_nonfinite:2", 1e-2)
    grads = [torch.from_numpy(rng.normal(size=7).astype(np.float32)) for _ in range(4)]
    a = Optimizer([torch.nn.Parameter(torch.ones(7))], config, accumulate_steps=2)
    for g in grads[:3]:
        a.step(g)
    b = Optimizer([torch.nn.Parameter(torch.ones(7))], config, accumulate_steps=2)
    held = {k: v for k, v in b.state.items()}
    b.load_state_dict(a.state_dict())
    with torch.no_grad():
        b.flat.copy_(a.flat)
    assert all(b.state[k] is v for k, v in held.items())
    a.step(grads[3])
    b.step(grads[3])
    assert torch.equal(a.flat, b.flat)
    assert all(torch.equal(a.state[k], b.state[k]) for k in a.state)


def test_weight_pack_follows_the_optimizer():
    """K1's weight pack is keyed by the parameters' version counters; the
    optimizer writes the parameters through its flat buffer, so it bumps
    them: the pack after a step is rebuilt, equal to one made afresh, and
    kept while nothing changes."""
    torch.manual_seed(0)
    model = StyleVAE(tconfig.ModelConfig.from_dict(dataclasses.asdict(small_config())))
    opt = Optimizer(list(model.parameters()), OptimizerConfig("adam", "", 1e-2))
    before = fd.pack_weights(model)
    assert fd.pack_weights(model) is before
    opt.step(torch.ones_like(opt.flat))
    after = fd.pack_weights(model)
    assert after is not before and fd.pack_weights(model) is after
    model._fused_decode_pack = None
    fresh = fd.pack_weights(model)
    for k in ("wt", "wf", "emb", "pos"):
        assert torch.equal(after[k], fresh[k])
    assert not torch.equal(after["wt"], before["wt"])


def test_train_step_and_eval_step(both_models):
    """One train_step equals the JAX loss's update by hand (same eps); the
    eval step's metrics equal the JAX eval step's, wrap rows masked."""
    jmodel, jparams, _ = both_models
    cfg = small_config()
    tmodel = StyleVAE(tconfig.ModelConfig.from_dict(dataclasses.asdict(cfg)))
    tmodel.load_state_dict(params_from_jax(jparams))
    tokens, seq_lens, classes, labels, eps = batch(4)
    ttensors = [torch.as_tensor(x).long() for x in (tokens, seq_lens, classes, labels)]

    jeval = make_eval_step(jmodel, JaxLossConfig(kl_weight=0.5))
    jm = jax.device_get(jeval(jparams, *map(jnp.asarray, (tokens, seq_lens, classes, labels)),
                              jnp.asarray(2, jnp.int32)))
    tm = eval_step(tmodel, LossConfig(kl_weight=0.5), *ttensors, 2)
    for k, (s, c) in jm.items():
        np.testing.assert_allclose(float(tm[k][0]), float(s), rtol=1e-4, err_msg=k)
        assert float(tm[k][1]) == float(c)

    extras = "clip_gradient:1.0,clip_global_norm:1.0,skip_nonfinite:3"
    opt = Optimizer(list(tmodel.parameters()), OptimizerConfig("adam", extras, 1e-3))
    acc = train_step(tmodel, opt, LossConfig(kl_weight=0.5, kl_anneal_steps=4), 2, None,
                     *ttensors, eps=torch.from_numpy(eps))
    (jtotal, _), jgrads = jax.value_and_grad(
        jax_loss(jmodel, *map(jnp.asarray, (tokens, seq_lens, classes, labels, eps)),
                 0.25, 0.0, 0.0), has_aux=True)(jparams)
    tx = build_optimizer(JaxOptimizerConfig("adam", extras, 1e-3))
    updates, _ = tx.update(jgrads, tx.init(jparams), jparams)
    want = params_from_jax(optax.apply_updates(jparams, updates))
    zero = {n for n, g in params_from_jax(jgrads).items() if float(g.abs().max()) < 1e-6}
    assert zero == {f"encoder.encoder.layers.{i}.attention.w_k.bias" for i in (0, 1)} | {
        "decoder.decoder.layers.0.attention.w_k.bias"}
    for name, p in tmodel.named_parameters():
        # Adam's first step is lr * sign(g): an element whose gradient is
        # float32 noise (all of the key bias's: softmax ignores a shift
        # shared by all keys) steps either way, so compare the elements
        # whose gradient stands above that noise.
        if name in zero:
            continue
        g = params_from_jax(jgrads)[name].abs()
        clear = (g > 1e-3 * g.max()).numpy()
        np.testing.assert_allclose(p.detach().numpy()[clear], want[name].numpy()[clear],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(acc["total_loss"][0]), float(jtotal), rtol=1e-4)
    np.testing.assert_allclose(float(acc["grad_norm"][0]), float(optax.global_norm(jgrads)),
                               rtol=1e-4)


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    for cls, name in [("bass", "Until_It_Sleeps_2_Bass-Guitar.mid"),
                      ("guitar", "Metal_Militia_Guitar-3.mid")]:
        os.makedirs(root / cls)
        shutil.copy(os.path.join(CORPUS, cls, name), root / cls / name)
    return str(root)


def train_argv(corpus, model, logdir, epochs, extra=()):
    """A tiny pre-LN model with dropout, the wide recipe's optimizer extras,
    3 steps an epoch (7 chunks of 8 tokens, batches of 3), a checkpoint
    every epoch, metrics every step."""
    return ["--cpu", "--data", corpus, "--model-output", model, "--logdir", logdir,
            "--batch-size", "3", "--max-seq-len", "8", "--validation-split", "0",
            "--epochs", str(epochs), "--checkpoint-frequency", "3", "--log-every", "1",
            "--e-n-layers", "1", "--e-rnn-hidden-dim", "32", "--e-num-heads", "4",
            "--e-dropout", "0.1", "--d-dropout", "0.1", "--latent-dim", "16",
            "--d-rnn-hidden-dim", "32", "--norm-scheme", "pre", "--use-flash-attention",
            "--dtype", "float32", "--kl-anneal-steps", "4", "--free-bits", "0.1",
            "--learning-rate", "0.01", "--gen-health-rows", "2",
            "--optimizer-params", "clip_gradient:1.0,clip_global_norm:1.0,warmup_steps:2,"
            "decay_steps:20,skip_nonfinite:10", *extra]


def scalars(logdir):
    with open(os.path.join(logdir, "scalars.jsonl")) as f:
        return [json.loads(x) for x in f]


def test_cli_trains_resumes_and_samples(tiny_corpus, tmp_path):
    from musicstyletransfer_torch.data import Loader, MelodyDataset
    from musicstyletransfer_torch.midi import smf
    from musicstyletransfer_torch.midi.codec import tokenize_track

    n = MelodyDataset(3, 8, Loader(tiny_corpus, 8).melodies).num_batches()
    assert n == 3
    u, r = str(tmp_path / "run"), str(tmp_path / "resumed")
    cli_main.main(train_argv(tiny_corpus, u, u + "-log", 2))
    assert sorted(os.listdir(u)) == ["params.1.pt", "params.2.pt", "torch", "train_state.json"]
    with open(os.path.join(u, "train_state.json")) as f:
        assert json.load(f)["n_batches"] == 6
    lines_u = scalars(u + "-log")
    train = [x for x in lines_u if "grad_norm" in x]
    assert [x["step"] for x in train] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(x["total_loss"]) for x in train)
    assert [x["nonfinite_updates_skipped"] for x in lines_u if "nonfinite_updates_skipped" in x] \
        == [0, 0]
    assert any("gen_termination_rate" in x for x in lines_u)

    # Resume the run as it stood at its first checkpoint: its next steps are
    # the uninterrupted run's (same batches, optimizer state and dropout).
    shutil.copytree(u, r, ignore=shutil.ignore_patterns("params.2.pt"))
    cli_main.main(train_argv(tiny_corpus, r, r + "-log", 1))
    resumed = [x for x in scalars(r + "-log") if "grad_norm" in x]
    assert [x["step"] for x in resumed] == [4, 5, 6]
    for a, b in zip(resumed, train[3:]):
        for k in ("ce_loss", "kl_loss", "total_loss", "grad_norm", "acc"):
            assert a[k] == pytest.approx(b[k], rel=1e-6), (a["step"], k)
    want = torch.load(os.path.join(u, "params.2.pt"), weights_only=False)["params"]
    got = torch.load(os.path.join(r, "params.2.pt"), weights_only=False)["params"]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)

    out = tmp_path / "samples"
    cli_sample.main(["--cpu", "--model-output", r, "--checkpoint", "-1", "--data", tiny_corpus,
                     "--out-samples", str(out), "--batch-size", "3", "--max-seq-len", "8"])
    names = sorted(os.listdir(out))
    assert len(names) == 3 * 3 * n
    for name in names:
        toks = np.concatenate([tokenize_track(t)
                               for t in smf.read_midifile(str(out / name)).tracks])
        assert (toks >= 3).all() and (toks < 293).all(), name


def test_cli_sample_reads_the_ports_own_checkpoints(tiny_corpus, tmp_path):
    """cli.sample --checkpoint N on a folder that cli.main trained loads
    params.N.pt: greedy tokens and the written MIDI equal those of a model
    given checkpoint N's flat parameters; -1 takes the latest; a missing N
    raises."""
    from musicstyletransfer_torch.data import Loader, MelodyDataset
    from musicstyletransfer_torch.inference import decode
    from musicstyletransfer_torch.inference.sampler import (Sampling, load_flat_params,
                                                             load_inference_model)
    from musicstyletransfer_torch.models.config import load_config

    u = str(tmp_path / "run")
    cli_main.main(train_argv(tiny_corpus, u, u + "-log", 2))
    flat = {n: torch.load(os.path.join(u, f"params.{n}.pt"), weights_only=False)["params"]
            for n in (1, 2)}
    assert not torch.equal(flat[1], flat[2])
    config, exported = load_config(os.path.join(u, "torch", "config.json"))
    assert exported == 2
    want = StyleVAE(config)
    load_flat_params(want, flat[1])
    want.eval()

    got = load_inference_model(u, 1)
    for a, b in zip(got.parameters(), want.parameters()):
        assert torch.equal(a, b)
    latest = load_inference_model(u, -1)
    assert torch.equal(torch.cat([p.reshape(-1) for p in latest.parameters()]), flat[2])
    with pytest.raises(ValueError, match=r"holds checkpoints \[1, 2\], not 5"):
        load_inference_model(u, 5)

    batch = next(iter(MelodyDataset(3, 8, Loader(tiny_corpus, 8).melodies)))
    args = [torch.as_tensor(np.asarray(x), dtype=torch.long)
            for x in (batch.tokens, batch.seq_lens, batch.classes)]
    seqs = [decode.sample_sequences(m, *args, 16, 0, greedy=True)[0] for m in (got, want)]
    assert torch.equal(seqs[0], seqs[1])

    out = tmp_path / "samples"
    cli_sample.main(["--cpu", "--model-output", u, "--checkpoint", "1", "--data", tiny_corpus,
                     "--out-samples", str(out), "--batch-size", "3", "--max-seq-len", "8"])
    ref = tmp_path / "reference"
    Sampling(None, None, model=want).process_dataset(
        MelodyDataset(3, 8, Loader(tiny_corpus, 8).melodies), str(ref))
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(ref)) and names
    for name in names:
        assert (out / name).read_bytes() == (ref / name).read_bytes(), name


@pytest.mark.parametrize("flag,message", [
    (["--tp", "2"], "one process per card"),
    (["--dist-coordinator", "127.0.0.1:1", "--dist-num-cpu-devices", "2"], "not ported")])
def test_cli_refuses_unported(flag, message, tmp_path):
    """--tp 2 without --dist-* names the one-process-per-card launch (a
    torch process drives one device); --dist-num-cpu-devices, the JAX
    package's virtual CPU devices, has no torch meaning. Both raise before
    anything starts."""
    with pytest.raises(SystemExit, match=message):
        cli_main.main(["--cpu", "--data", CORPUS, "--model-output", str(tmp_path), *flag])


def test_cli_trains_as_a_one_process_gloo_world(tiny_corpus, tmp_path):
    """--dist-* with --dist-num-processes 1 --cpu joins a gloo world of one
    rank, trains on its (1, 1) mesh, checkpoints and leaves no process group
    behind."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    model = str(tmp_path / "m")
    cli_main.main(train_argv(tiny_corpus, model, str(tmp_path / "log"), 1) + [
        "--dist-coordinator", f"127.0.0.1:{port}", "--dist-num-processes", "1",
        "--dist-process-id", "0"])
    assert not dist.is_initialized()
    state = ckpt.restore_checkpoint(model, ckpt.checkpoint_indices(model)[-1])
    assert state["step"] == 3 and torch.isfinite(state["params"]).all()


@pytest.mark.parametrize("flag", ["--grad-accum-steps", "--profile-dir",
                                  "--log-param-grad-norms", "--steps-per-dispatch",
                                  "--prefetch"])
def test_cli_runs_the_flags_the_jax_cli_has(flag, tiny_corpus, tmp_path):
    """Each flag through cli.main (3 steps an epoch): --grad-accum-steps 2
    applies the optimizer every 2nd step; --profile-dir writes the trace of
    steps 10-20 (4 epochs); --log-param-grad-norms logs one gradient norm
    per parameter under the JAX package's names; --steps-per-dispatch 2
    logs at group boundaries (an epoch's remainder is a group of its own);
    --prefetch 0 trains without the prefetching thread."""
    from musicstyletransfer_torch.convert import flax_names
    from musicstyletransfer_torch.inference.sampler import load_inference_model

    model = str(tmp_path / "m")
    value = {"--grad-accum-steps": "2", "--profile-dir": str(tmp_path / "profile"),
             "--steps-per-dispatch": "2", "--prefetch": "0"}
    epochs = 4 if flag == "--profile-dir" else 2
    extra = [flag, value[flag]] if flag in value else [flag]
    cli_main.main(train_argv(tiny_corpus, model, model + "-log", epochs, extra=extra))
    train = [x for x in scalars(model + "-log") if "grad_norm" in x]
    assert train and all(np.isfinite(x["total_loss"]) for x in train)
    state = torch.load(os.path.join(model, f"params.{epochs}.pt"), weights_only=False)
    assert int(state["step"]) == 3 * epochs
    if flag == "--grad-accum-steps":
        assert int(state["optimizer"]["count"]) == 3
        assert int(state["optimizer"]["mini_step"]) == 0
    elif flag == "--profile-dir":
        assert os.listdir(value[flag]) == ["trace.json"]
    elif flag == "--log-param-grad-norms":
        names = {k[len("grad_norm/"):] for k in train[0] if k.startswith("grad_norm/")}
        assert names == set(flax_names(load_inference_model(model, -1)))
        assert all(x[f"grad_norm/{n}"] >= 0 for x in train for n in names)
    elif flag == "--steps-per-dispatch":
        assert [x["step"] for x in train] == [2, 3, 5, 6]


def test_cli_runs_on_cuda_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        cli_main.main(["--data", CORPUS, "--model-output", str(tmp_path)])


def test_trainer_early_stop_pruning_and_sampling(tiny_corpus, tmp_path):
    """With a learning rate of 0 the validation loss never improves after
    the first checkpoint: training stops at the checkpoint where the count
    of unimproved ones reaches the limit. keep_checkpoints prunes older
    ones, and in-training sampling writes MIDI at its ticks."""
    model = str(tmp_path / "m")
    cli_main.main(train_argv(tiny_corpus, model, model + "-log", 10, extra=[
        "--validation-data", tiny_corpus, "--learning-rate", "0", "--checkpoint-frequency", "2",
        "--num-checkpoints-not-improved", "2", "--keep-checkpoints", "1",
        "--sampling-frequency", "4"]))
    with open(os.path.join(model, "train_state.json")) as f:
        progress = json.load(f)
    assert progress["n_checkpoints"] == 3 and progress["n_batches"] == 6
    assert progress["num_checkpoints_not_improved"] == 2
    assert sorted(n for n in os.listdir(model) if n.endswith(".pt")) == ["params.3.pt"]
    assert sorted(os.listdir(os.path.join(model, "samples"))) == ["step-4"]
    assert len(os.listdir(os.path.join(model, "samples", "step-4"))) == 3 * 3
