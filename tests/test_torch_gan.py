"""PyTorch port, the GAN family against the JAX package on the same weights,
noise and draws (CPU, float32 unless stated):

- the rebuild of ``jax.random.categorical``'s draws (argmax of
  ``jax.random.gumbel`` plus the logits) equals ``categorical``;
- the ``Generator``, soft and hard, fed the JAX generator's noise and its
  per-step Gumbel rebuilt from the same keys: logits 1e-4, hard tokens
  identical;
- the ``Discriminator`` with and without projection: 1e-5;
- ``binary_cross_entropy`` with smoothing and downweighting: 1e-6;
- ``d_step`` (R1 0.1 and 0) and ``g_step`` from the same parameters and
  noise: the loss, R1 and every gradient against ``jax.value_and_grad`` of
  the JAX trainer's loss: 1e-4; the parameters after the step against the
  JAX trainer's own step (optax Adam): 1e-6;
- each step leaves the other model untouched; the converter both ways;
- ``GANTrainer.fit`` on ToyData: the D:G alternation, resume, the fallback
  on a corrupt pair, the MIDI files; ``cli.gan``'s flags against
  ``build_gan_parser``'s;
- the shipped generator (``models/gan_guitar_bass``, its own widths): its
  export against the Orbax checkpoint, float32 logits for fixed noise to
  1e-4 and its hard rollout token for token; at its bfloat16 the first
  step's logits to 2e-2 (bf16 rounds h at 2^-8 relative before a 256-wide
  float32 head; 5.2e-3 on the CPU at these inputs), and the two pins of ``tests/test_pretrained.py:160-210``
  (note-on fraction > 0.1, octave JS own < other) on the port's own draws;
  ``cli.gan --generate`` from it.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from musicstyletransfer_tpu.cli.gan import build_gan_parser as jax_build_gan_parser
from musicstyletransfer_tpu.models import gan as jgan
from musicstyletransfer_tpu.training.gan_trainer import GANTrainConfig as JaxGANTrainConfig
from musicstyletransfer_tpu.training.gan_trainer import init_gan_metric_acc, make_gan_steps
from musicstyletransfer_tpu.training.loss import binary_cross_entropy as jax_bce
from musicstyletransfer_tpu.training.train_step import create_train_state
from musicstyletransfer_torch.cli import gan as cli_gan
from musicstyletransfer_torch.convert import load_npz, params_from_jax, params_to_jax
from musicstyletransfer_torch.data import Loader, ToyData
from musicstyletransfer_torch.inference.quality import js_divergence, octave_histogram
from musicstyletransfer_torch.midi import smf
from musicstyletransfer_torch.midi.vocab import NUM_EVENTS, is_note_on
from musicstyletransfer_torch.models.config import GANConfig, load_gan_config
from musicstyletransfer_torch.models.gan import generate_tokens, make_discriminator, make_generator
from musicstyletransfer_torch.training import gan_trainer
from musicstyletransfer_torch.training.gan_trainer import (GANSteps, GANTrainConfig,
                                                           GANTrainer, group_pattern)
from musicstyletransfer_torch.training.loss import binary_cross_entropy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "work", "data", "guitar_bass")
SHIPPED = os.path.join(REPO, "models", "gan_guitar_bass")
CPU = torch.device("cpu")
B, L, V, C, N = 5, 8, 12, 3, 4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_config(projection=True, dtype="float32") -> jgan.GANConfig:
    return jgan.GANConfig(
        generator_config=jgan.GeneratorConfig(n_layers=2, hidden_dim=16, emb_dim=8,
                                              noise_dim=N, num_classes=C, output_dim=V,
                                              max_seq_len=L),
        discriminator_config=jgan.DiscriminatorConfig(n_layers=2, hidden_dim=16, emb_dim=8,
                                                      num_classes=C, input_dim=V,
                                                      projection=projection),
        dtype=dtype)


def port_config(cfg) -> GANConfig:
    return GANConfig.from_dict(dataclasses.asdict(cfg))


def port_models(cfg, g_params, d_params):
    pcfg = port_config(cfg)
    gen, disc = make_generator(pcfg), make_discriminator(pcfg)
    gen.load_state_dict(params_from_jax(g_params))
    disc.load_state_dict(params_from_jax(d_params))
    return pcfg, gen, disc


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    g_params, d_params = jgan.init_gan_params(cfg, jax.random.key(0))
    return cfg, g_params, d_params


def rebuilt_gumbel(roll_key, steps, shape):
    """The JAX generator's per-step Gumbel noise [L, B, V]: its rollout
    draws ``categorical(split(roll_key, L)[t], logits_t)``."""
    keys = jax.random.split(roll_key, steps)
    return np.stack([np.asarray(jax.random.gumbel(k, shape, jnp.float32)) for k in keys])


def _np(x):
    return np.asarray(x)


def test_gumbel_rebuild_equals_categorical():
    """``jax.random.categorical(key, x)`` is argmax(gumbel(key, x.shape) + x)
    on a fixed case (the premise of the rebuilt draws below)."""
    x = jnp.asarray(np.random.default_rng(0).normal(0, 3, (64, 293)), jnp.float32)
    for i in range(4):
        k = jax.random.key(i)
        want = _np(jax.random.categorical(k, x))
        got = np.argmax(_np(jax.random.gumbel(k, x.shape, jnp.float32)) + _np(x), -1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hard", [False, True])
def test_generator_matches_jax(tiny, hard):
    """The rollout from the same noise with the JAX draws rebuilt: logits
    1e-4 and tokens identical (soft mode's tokens are drawn too, unused)."""
    cfg, g_params, d_params = tiny
    _, gen, _ = port_models(cfg, g_params, d_params)
    noise = np.random.default_rng(1).normal(size=(B, L, N)).astype(np.float32)
    classes = np.array([0, 1, 2, 0, 1])
    key = jax.random.key(7)
    jlogits, jtokens = jgan.make_generator(cfg).apply(
        {"params": g_params}, jnp.asarray(noise), jnp.asarray(classes), key, hard=hard,
        temperature=0.8)
    with torch.no_grad():
        logits, tokens = gen(torch.tensor(noise), torch.tensor(classes), hard=hard,
                             temperature=0.8,
                             gumbel_noise=torch.tensor(rebuilt_gumbel(key, L, (B, V))))
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), atol=1e-4)
    np.testing.assert_array_equal(tokens.numpy(), _np(jtokens))


@pytest.mark.parametrize("projection", [True, False])
def test_discriminator_matches_jax(projection):
    """Per-step logits of soft token distributions: 1e-5."""
    cfg = tiny_config(projection=projection)
    g_params, d_params = jgan.init_gan_params(cfg, jax.random.key(1))
    if projection:  # init draws class_proj small; spread it so the term shows
        d_params = dict(d_params, class_proj={"embedding": jnp.asarray(
            np.random.default_rng(2).normal(size=(C, 16)), jnp.float32)})
    _, _, disc = port_models(cfg, g_params, d_params)
    rng = np.random.default_rng(3)
    dists = rng.dirichlet(np.ones(V), size=(B, L)).astype(np.float32)
    classes = np.array([2, 1, 0, 0, 1])
    want = jgan.make_discriminator(cfg).apply({"params": d_params}, jnp.asarray(dists),
                                              jnp.asarray(classes))
    with torch.no_grad():
        got = disc(torch.tensor(dists), torch.tensor(classes))
    assert not projection or "class_proj.weight" in dict(disc.named_parameters())
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)


@pytest.mark.parametrize("from_sigmoid", [False, True])
@pytest.mark.parametrize("smoothing,downweight", [(0.0, False), (0.1, False), (0.2, True),
                                                  (0.0, True)])
def test_binary_cross_entropy_matches_jax(from_sigmoid, smoothing, downweight):
    """Per-sample BCE on [4, 6] predictions with mixed labels (one row all
    ones, one all zeros): 1e-6."""
    rng = np.random.default_rng(4)
    pred = rng.normal(0, 3, (4, 6)).astype(np.float32)
    if from_sigmoid:
        pred = 1 / (1 + np.exp(-pred))
    label = (rng.random((4, 6)) < 0.5).astype(np.float32)
    label[0], label[1] = 1.0, 0.0
    want = jax_bce(jnp.asarray(pred), jnp.asarray(label), from_sigmoid=from_sigmoid,
                   label_smoothing=smoothing, negative_label_downweighting=downweight)
    got = binary_cross_entropy(torch.tensor(pred), torch.tensor(label),
                               from_sigmoid=from_sigmoid, label_smoothing=smoothing,
                               negative_label_downweighting=downweight)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6)


def test_converter_round_trip(tiny):
    """``params_to_jax(params_from_jax(t)) == t`` for the generator's and
    the discriminator's trees (the discriminator's cells at the top level)."""
    cfg, g_params, d_params = tiny
    _, gen, disc = port_models(cfg, g_params, d_params)
    for tree, model in ((g_params, gen), (d_params, disc)):
        flat = traverse_util.flatten_dict(tree, sep="/")
        back = params_to_jax(model)
        assert sorted(back) == sorted(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(back[k], _np(v), err_msg=k)
    assert "cell/lstm1/hg/kernel" in params_to_jax(gen)
    assert "OptimizedLSTMCell_1/ii/kernel" in params_to_jax(disc)


# --------------------------------------------------------------------------
# The steps


def jax_states(cfg, g_params, d_params, tc):
    d_step, g_step, g_tx, d_tx = make_gan_steps(cfg, tc)
    g_state = create_train_state(g_params, g_tx, jax.random.key(1))
    d_state = create_train_state(d_params, d_tx, jax.random.key(2))
    return d_step, g_step, g_state, d_state


def step_noise(state, shape):
    """The noise the JAX trainer's step draws: normal(split(fold_in(rng, step))[0])."""
    key = jax.random.fold_in(state.rng, state.step)
    noise_key, _ = jax.random.split(key)
    return np.asarray(jax.random.normal(noise_key, shape, jnp.float32))


def recording(opt):
    """Make ``opt.step`` record the flat gradient it is handed."""
    seen = []
    step = opt.step

    def record(grad):
        seen.append(grad.clone())
        step(grad)

    opt.step = record
    return seen


def assert_grads(model, opt, flat_grad, jgrads, atol):
    want = params_from_jax(jgrads)
    names = [n for n, _ in model.named_parameters()]
    for name, g in zip(names, opt.views(flat_grad)):
        np.testing.assert_allclose(g.reshape(want[name].shape).numpy(), want[name].numpy(),
                                   atol=atol, err_msg=name)


def assert_params(model, jparams, atol):
    got = params_to_jax(model)
    for k, v in traverse_util.flatten_dict(jparams, sep="/").items():
        np.testing.assert_allclose(got[k], _np(v), atol=atol, err_msg=k)


@pytest.fixture
def batch():
    rng = np.random.default_rng(5)
    return rng.integers(3, V, (B, L)), np.array([0, 1, 2, 1, 0])


@pytest.mark.parametrize("r1_gamma", [0.1, 0.0])
def test_d_step_matches_jax(tiny, batch, r1_gamma):
    """One D step from the same parameters and noise, smoothing 0.1 and
    downweighting on: loss, R1 and every gradient against
    ``jax.value_and_grad`` of the JAX trainer's D loss (1e-4), and the
    parameters after Adam against the JAX trainer's ``d_step`` (1e-6)."""
    cfg, g_params, d_params = tiny
    tokens, classes = batch
    jtc = JaxGANTrainConfig(r1_gamma=r1_gamma, label_smoothing=0.1,
                            negative_label_downweighting=True)
    d_step, _, g_state, d_state = jax_states(cfg, g_params, d_params, jtc)
    noise = step_noise(d_state, (B, L, N))
    gen, disc = jgan.make_generator(cfg), jgan.make_discriminator(cfg)
    jlogits, _ = gen.apply({"params": g_params}, jnp.asarray(noise), jnp.asarray(classes),
                           jax.random.key(0), hard=False)
    fake = jax.nn.softmax(jlogits)
    real = jax.nn.one_hot(jnp.asarray(tokens), V, dtype=jnp.float32)
    cl = jnp.asarray(classes)

    def loss_fn(p):
        gin, pred_real = jax.grad(lambda x: (lambda q: (jnp.sum(q), q))(
            disc.apply({"params": p}, x, cl)), has_aux=True)(real)
        r1 = jnp.mean(jnp.sum(jnp.square(gin), axis=(1, 2)))
        pred_fake = disc.apply({"params": p}, fake, cl)
        pred = jnp.concatenate([pred_real, pred_fake], axis=1)
        label = jnp.concatenate([jnp.ones_like(pred_real), jnp.zeros_like(pred_fake)], axis=1)
        loss = jnp.mean(jax_bce(pred, label, label_smoothing=0.1,
                                negative_label_downweighting=True))
        return loss + 0.5 * r1_gamma * r1, r1

    (jloss, jr1), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(d_params)
    new_d, _ = d_step(d_state, init_gan_metric_acc(), g_params, jnp.asarray(tokens), cl)

    pcfg, pgen, pdisc = port_models(cfg, g_params, d_params)
    tc = GANTrainConfig(r1_gamma=r1_gamma, label_smoothing=0.1, negative_label_downweighting=True)
    steps = GANSteps(pcfg, tc, pgen, pdisc, torch.Generator().manual_seed(0))
    seen = recording(steps.d_opt)
    steps.d_step(torch.tensor(tokens), torch.tensor(classes), noise=torch.tensor(noise))
    m = steps.metrics()
    np.testing.assert_allclose(m["d_loss"], float(jloss), atol=1e-4)
    np.testing.assert_allclose(m["d_r1"], float(jr1) if r1_gamma else 0.0, atol=1e-4)
    assert set(m) == {"d_loss", "d_acc_real", "d_acc_fake", "d_r1"}
    assert_grads(pdisc, steps.d_opt, seen[0], jgrads, 1e-4)
    assert_params(pdisc, new_d.params, 1e-6)


def test_g_step_matches_jax(tiny, batch):
    """One G step from the same parameters and noise: the non-saturating
    loss and every generator gradient against ``jax.value_and_grad`` (1e-4),
    the parameters after Adam against the JAX trainer's ``g_step`` (1e-6)."""
    cfg, g_params, d_params = tiny
    _, classes = batch
    _, g_step, g_state, _ = jax_states(cfg, g_params, d_params, JaxGANTrainConfig())
    noise = step_noise(g_state, (B, L, N))
    gen, disc = jgan.make_generator(cfg), jgan.make_discriminator(cfg)
    cl = jnp.asarray(classes)

    def loss_fn(p):
        logits, _ = gen.apply({"params": p}, jnp.asarray(noise), cl, jax.random.key(0),
                              hard=False)
        pred = disc.apply({"params": d_params}, jax.nn.softmax(logits), cl)
        return jnp.mean(jax_bce(pred, jnp.ones_like(pred), negative_label_downweighting=False))

    jloss, jgrads = jax.value_and_grad(loss_fn)(g_params)
    new_g, _ = g_step(g_state, init_gan_metric_acc(), d_params, cl)

    pcfg, pgen, pdisc = port_models(cfg, g_params, d_params)
    steps = GANSteps(pcfg, GANTrainConfig(), pgen, pdisc, torch.Generator().manual_seed(0))
    seen = recording(steps.g_opt)
    steps.g_step(torch.tensor(classes), noise=torch.tensor(noise))
    np.testing.assert_allclose(steps.metrics()["g_loss"], float(jloss), atol=1e-4)
    assert_grads(pgen, steps.g_opt, seen[0], jgrads, 1e-4)
    assert_params(pgen, new_g.params, 1e-6)


def test_steps_leave_the_other_model_untouched(tiny, batch):
    """A G step changes no D parameter, Adam moment or ``.grad``; a D step
    (with R1) none of G's."""
    cfg, g_params, d_params = tiny
    tokens, classes = batch
    pcfg, pgen, pdisc = port_models(cfg, g_params, d_params)
    steps = GANSteps(pcfg, GANTrainConfig(), pgen, pdisc, torch.Generator().manual_seed(0))

    def snapshot(opt):
        return [opt.flat.clone(), *(v.clone() for v in opt.state.values())]

    d_before = snapshot(steps.d_opt)
    steps.g_step(torch.tensor(classes))
    assert all(torch.equal(a, b) for a, b in zip(d_before, snapshot(steps.d_opt)))
    assert all(p.grad is None for p in pdisc.parameters())
    g_before = snapshot(steps.g_opt)
    steps.d_step(torch.tensor(tokens), torch.tensor(classes))
    assert all(torch.equal(a, b) for a, b in zip(g_before, snapshot(steps.g_opt)))
    assert all(p.grad is None for p in pgen.parameters())
    assert not torch.equal(d_before[0], steps.d_opt.flat)


# --------------------------------------------------------------------------
# The trainer and the CLI


def test_group_pattern():
    """A G step follows the D step of batch n where n % k == 0, n counted
    across groups: a group of 5 from 0 is D,G,D,D,D,D; one from 3 of 4
    batches has its G after the third."""
    assert group_pattern(0, 5, 5) == [True, False, False, False, False]
    assert group_pattern(3, 4, 5) == [False, False, True, False]
    assert group_pattern(7, 1, 1) == [True]


def toy_config(args=()):
    return cli_gan.create_gan_config(cli_gan.get_gan_config(["--dtype", "float32", *args]),
                                     3, 10, 4)


def test_fit_alternates_resumes_and_writes_midi(tmp_path, capsys):
    """ToyData (one batch an epoch) for 12 epochs, D:G = 5:1, a checkpoint
    every 5 batches, samples every 6: 12 D and 3 G updates (batches 0, 5,
    10), checkpoints 1-3 (the last at the end), MIDI ``gan-out-{i}.class-
    {c}.mid`` that parses back, scalars every 4 batches. A second fit
    resumes from checkpoint 3 and writes 4-6."""
    folder, out = str(tmp_path / "gan"), str(tmp_path / "samples")
    tc = GANTrainConfig(checkpoint_frequency=5, sampling_frequency=6, num_samples=2,
                        log_every=4, logdir=str(tmp_path / "log"))
    trainer = GANTrainer(toy_config(), tc, out_samples=out, device=CPU)
    last = trainer.fit(ToyData(), folder, epochs=12)
    assert int(trainer.steps.d_opt.state["count"]) == 12
    assert int(trainer.steps.g_opt.state["count"]) == 3
    assert set(last) == set(gan_trainer.GAN_METRIC_KEYS)
    assert all(np.isfinite(v) for v in last.values())
    assert sorted(os.listdir(os.path.join(folder, "generator"))) == [
        "params.1.pt", "params.2.pt", "params.3.pt"]
    assert sorted(os.listdir(out)) == ["step-12", "step-6"]
    names = sorted(os.listdir(os.path.join(out, "step-6")))
    assert names == sorted(f"gan-out-{i}.class-{c}.mid" for i in range(2) for c in range(3))
    for name in names:
        smf.read_midifile(os.path.join(out, "step-6", name))
    with open(str(tmp_path / "log" / "scalars.jsonl")) as f:
        assert [json.loads(x)["step"] for x in f] == [4, 8, 12]
    flat = trainer.steps.g_opt.flat.clone()

    again = GANTrainer(toy_config(), dataclasses.replace(tc, logdir=None), out_samples=None,
                       device=CPU)
    again.fit(ToyData(), folder, epochs=1)
    assert "resumed GAN from checkpoint 3" in capsys.readouterr().out
    assert int(again.steps.d_opt.state["count"]) == 13
    assert sorted(os.listdir(os.path.join(folder, "generator")))[-1] == "params.4.pt"
    assert not torch.equal(again.steps.g_opt.flat, flat)  # batch 0 of the new run: a G step


def test_fit_falls_back_on_a_corrupt_pair(tmp_path, capsys):
    """A pair whose discriminator half does not load trains from scratch:
    the generator starts from its fresh initialisation (not from the
    readable generator half), and the next checkpoint is number 1."""
    folder = str(tmp_path / "gan")
    tc = GANTrainConfig(checkpoint_frequency=0, log_every=1000)
    GANTrainer(toy_config(), tc, device=CPU).fit(ToyData(), folder, epochs=2)
    with open(os.path.join(folder, "discriminator", "params.1.pt"), "wb") as f:
        f.write(b"not a checkpoint")
    fresh = GANTrainer(toy_config(), tc, device=CPU)
    fresh._build()
    init = fresh.steps.g_opt.flat.clone()
    trainer = GANTrainer(toy_config(), tc, device=CPU)
    seen = []
    orig = GANTrainer._try_resume

    def spy(self, f):
        idx = orig(self, f)
        seen.append((idx, self.steps.g_opt.flat.clone()))
        return idx

    trainer._try_resume = spy.__get__(trainer)
    trainer.fit(ToyData(), folder, epochs=1)
    assert "training from scratch" in capsys.readouterr().out
    assert seen[0][0] == 0 and torch.equal(seen[0][1], init)


def test_cli_gan_flags_match_the_jax_parser():
    """Every flag of ``build_gan_parser`` with its default, type and action,
    and ``parse_known_args`` of train-gan.sh's flags plus unknown ones."""
    def surface(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, type(a).__name__)
                for a in parser._actions if a.dest != "help"}

    assert surface(cli_gan.build_gan_parser()) == surface(jax_build_gan_parser())
    argv = ["--batch-size", "32", "--sampling-frequency", "50", "--r1-gamma", "0",
            "--parity-gan", "--unknown-flag", "3", "--noise-dim", "64", "--gpu"]
    assert vars(cli_gan.get_gan_config(argv)) == vars(
        jax_build_gan_parser().parse_known_args(argv)[0])


def test_mesh_is_refused():
    """``mesh=`` (data-parallel GAN training) raises, naming ROADMAP item 9c."""
    with pytest.raises(NotImplementedError, match="item 9c"):
        GANTrainer(toy_config(), GANTrainConfig(), mesh=object())


def test_trainer_needs_a_card_or_a_device():
    """``GANTrainer`` without ``device=`` runs on CUDA: where there is no
    card it raises instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        GANTrainer(toy_config(), GANTrainConfig())


def test_cli_gan_needs_a_card_or_cpu():
    """Without ``--cpu`` and without a card, ``cli.gan`` raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_gan.main(["--toy"])


def test_cli_gan_toy_and_generate_from_its_checkpoint(tmp_path, capsys):
    """``cli.gan --toy --cpu`` (a few epochs) then ``--generate 2`` on its
    folder: the port's own checkpoint is read, 2 files a class written."""
    folder = str(tmp_path / "toy")
    cli_gan.main_toy(cli_gan.get_gan_config(["--cpu", "--g-rnn-hidden-dim", "16",
                                             "--d-rnn-hidden-dim", "16"]),
                     epochs=6, model_folder=folder)
    out = str(tmp_path / "gen")
    cli_gan.main(["--cpu", "--generate", "2", "--model-output", folder, "--out-samples", out,
                  "--data", str(tmp_path / "no-corpus")])
    assert "from checkpoint 1" in capsys.readouterr().out
    assert len(os.listdir(out)) == 2 * 3


# --------------------------------------------------------------------------
# The shipped generator


@pytest.fixture(scope="module")
def shipped():
    """(JAX config, JAX generator params restored from Orbax, the port's
    generator from the committed export ``models/gan_guitar_bass/torch``)."""
    from musicstyletransfer_tpu.models.config import Config
    from musicstyletransfer_tpu.training import get_latest_checkpoint_index, restore_params

    config = Config.load(os.path.join(SHIPPED, "config"))
    gen_folder = os.path.join(SHIPPED, "generator")
    template, _ = jgan.init_gan_params(config, jax.random.key(0))
    g_params = restore_params(gen_folder, get_latest_checkpoint_index(gen_folder), template)
    pcfg, idx = load_gan_config(os.path.join(SHIPPED, "torch", "config.json"))
    assert idx == get_latest_checkpoint_index(gen_folder) and pcfg == port_config(config)
    return config, g_params, load_npz(os.path.join(SHIPPED, "torch", "params.npz"))


def shipped_generator(shipped, dtype):
    config, _, npz = shipped
    gen = make_generator(dataclasses.replace(port_config(config), dtype=dtype))
    gen.load_state_dict(params_from_jax(npz))
    return gen.eval()


def test_shipped_export_equals_the_checkpoint(shipped):
    _, g_params, npz = shipped
    flat = traverse_util.flatten_dict(g_params, sep="/")
    assert sorted(flat) == sorted(npz)
    for k, v in flat.items():
        np.testing.assert_array_equal(npz[k], _np(v), err_msg=k)


def test_shipped_generator_matches_jax_float32(shipped):
    """Float32 on both sides, 4 rows of fixed noise, the JAX draws rebuilt:
    the hard rollout's 64 x 293 logits to 1e-4 and its tokens identical."""
    config, g_params, _ = shipped
    cfg = dataclasses.replace(config, dtype="float32")
    gc = cfg.generator_config
    noise = np.random.default_rng(8).normal(size=(4, gc.max_seq_len, gc.noise_dim))
    noise = noise.astype(np.float32)
    classes = np.array([0, 1, 0, 1])
    key = jax.random.key(9)
    jlogits, jtokens = jgan.make_generator(cfg).apply(
        {"params": g_params}, jnp.asarray(noise), jnp.asarray(classes), key, hard=True)
    gen = shipped_generator(shipped, "float32")
    with torch.no_grad():
        logits, tokens = gen(torch.tensor(noise), torch.tensor(classes), hard=True,
                             gumbel_noise=torch.tensor(rebuilt_gumbel(key, gc.max_seq_len,
                                                                      (4, NUM_EVENTS))))
    np.testing.assert_array_equal(tokens.numpy(), _np(jtokens))
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), atol=1e-4)


def test_shipped_generator_bf16_first_step(shipped):
    """At the shipped bfloat16, the first step's logits (before any draw
    can flip a token) against JAX's: 2e-2 (see the module docstring)."""
    config, g_params, _ = shipped
    gc = config.generator_config
    noise = np.random.default_rng(10).normal(size=(8, 1, gc.noise_dim)).astype(np.float32)
    classes = np.array([0, 1] * 4)
    jlogits, _ = jgan.make_generator(config).apply(
        {"params": g_params}, jnp.asarray(noise), jnp.asarray(classes), jax.random.key(0),
        hard=True)
    gen = shipped_generator(shipped, "bfloat16")
    with torch.no_grad():
        logits, _ = gen(torch.tensor(noise), torch.tensor(classes), hard=True,
                        generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), atol=2e-2)


def test_shipped_generator_pins_on_the_ports_draws(shipped):
    """The two pins of ``tests/test_pretrained.py`` at the shipped bfloat16
    on the port's own draws: 4 rows (classes 0, 0, 1, 1) of note-on
    fraction above 0.1; 16 rows a class whose octave profile is closer to
    its own class's corpus than to the other's."""
    gen = shipped_generator(shipped, "bfloat16")
    tokens = generate_tokens(gen, torch.tensor([0, 0, 1, 1]),
                             torch.Generator().manual_seed(3)).numpy()
    assert tokens.shape == (4, 64) and tokens.min() >= 0 and tokens.max() < NUM_EVENTS
    ons = np.mean([is_note_on(int(t)) for t in tokens.ravel()])
    assert ons > 0.1, ons
    loader = Loader(CORPUS, 64)
    corpus = {i: [m.tokens for m in loader.melodies[name]]
              for i, name in enumerate(sorted(loader.melodies))}
    hist = {c: octave_histogram(list(generate_tokens(
        gen, torch.full((16,), c), torch.Generator().manual_seed(100 + c)).numpy()))
        for c in range(2)}
    for c in range(2):
        own = js_divergence(hist[c], octave_histogram(corpus[c]))
        other = js_divergence(hist[c], octave_histogram(corpus[1 - c]))
        assert own < other, (c, own, other)


def test_cli_gan_generate_from_the_shipped_folder(tmp_path, capsys):
    """``cli.gan --generate 4 --cpu`` on ``models/gan_guitar_bass`` (no port
    checkpoints there: the ``torch/`` export) writes 4 MIDIs a class and one
    JSON line of ``class_conditional_stats`` whose classes separate."""
    out = str(tmp_path / "gen")
    cli_gan.main(["--cpu", "--generate", "4", "--model-output", SHIPPED, "--out-samples", out,
                  "--data", CORPUS])
    text = capsys.readouterr().out
    stats = json.loads(text.strip().splitlines()[-1])
    assert "from checkpoint 1" in text
    assert sorted(os.listdir(out)) == sorted(f"gan-out-{i}.class-{c}.mid"
                                             for i in range(4) for c in range(2))
    assert stats["gen_sequences"] == 8 and stats["gen_note_on_fraction"] > 0.1
