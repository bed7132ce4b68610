"""Multi-process training in the PyTorch port (``musicstyletransfer_torch/
parallel/``, the mesh paths of the model, the optimizer and the trainer,
``cli.main --tp/--dist-*``) against the JAX package's meshes and against one
process, on the CPU: the ranks are gloo processes (``tests/torch_dist_worker.py``
and ``cli.main`` itself), the JAX references run here on ``conftest.py``'s
virtual CPU devices.

Tolerances (float32 on both sides; the sums run in other orders and, under
tensor parallelism, over partial products): the TP rules and shards, the
process-sharded batches and the recipe flags exactly; tp=2 logits 1e-4 and
loss 1e-5 against JAX on a (1, 2) mesh on the dense, core and flash routes,
the gathered gradient 1e-5; the global norm and the clipped SGD step 1e-6 against optax;
DP=2, tp=2 and ring tp=2 training against one process on the global batch,
dropout on, 1e-5 on the parameters after 3 steps (the logged means 1e-5
relative, 1e-6 absolute for gradient norms of float32 noise); the same through
``cli.main`` (2 processes against 1) 1e-5; a resumed 2-process run equals
the uninterrupted one bit for bit.
"""

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from musicstyletransfer_tpu.data import Loader as JLoader
from musicstyletransfer_tpu.data import MelodyDataset as JMelodyDataset
from musicstyletransfer_tpu.models import (DecoderConfig, EncoderConfig, ModelConfig,
                                           TransformerConfig, init_params, make_model)
from musicstyletransfer_tpu.parallel import distributed as jdist
from musicstyletransfer_tpu.parallel import mesh as jmesh
from musicstyletransfer_tpu.training.loss import vae_loss as jax_vae_loss
from musicstyletransfer_torch.cli import sample as cli_sample
from musicstyletransfer_torch.convert import params_from_jax
from musicstyletransfer_torch.inference.sampler import load_inference_model
from musicstyletransfer_torch.models import StyleVAE
from musicstyletransfer_torch.models.config import ModelConfig as TModelConfig
from musicstyletransfer_torch.parallel import mesh as tmesh
from musicstyletransfer_torch.training import checkpoint as ckpt
from musicstyletransfer_torch.training.optimizer import OptimizerConfig
from musicstyletransfer_torch.training.trainer import TrainConfig, Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
CORPUS = os.path.join(REPO, "work", "data", "guitar_bass")
B, L = 4, 8
PROCESS_SPEC = {"corpus": CORPUS, "L": 16, "batch": 8}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


# the attention route of each TP case at T = L+1 / L+2: dense, the core (K2/K3's
# plain versions on each rank's heads) and flash (K4/K5's)
ROUTES = {"dense": {},
          "core": {"use_flash_attention": True, "attention_core_min_seq_len": 1},
          "flash": {"use_flash_attention": True, "flash_min_seq_len": 8}}


def jax_config(dropout=0.0, ring=False, heads=4, size=32, route="dense"):
    def tc(layers):
        return TransformerConfig(model_size=size, num_layers=layers, num_heads=heads,
                                 dropout=dropout, vocab_size=293, ring_attention=ring,
                                 **ROUTES[route])

    return ModelConfig(encoder_config=EncoderConfig(transformer_config=tc(2), latent_dim=16),
                       decoder_config=DecoderConfig(transformer_config=tc(1), latent_dim=16),
                       dtype="float32")


def torch_model(cfg, jparams):
    model = StyleVAE(TModelConfig.from_dict(dataclasses.asdict(cfg)))
    model.load_state_dict(params_from_jax(jparams))
    return model


def port_flat(tree, model):
    """A flax tree (parameters or gradients) as one vector in the port's
    parameter order and layouts."""
    sd = params_from_jax(tree)
    return np.concatenate([sd[n].numpy().ravel() for n, _ in model.named_parameters()])


def make_batch(seed, rows=B):
    """SOS-prefixed tokens [rows, L+1], labels with an EOS, PAD after."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((rows, L + 1), np.int32)
    labels = np.zeros((rows, L + 1), np.int32)
    tokens[:, 0] = 1
    for b, n in enumerate(rng.integers(3, L + 1, rows)):
        body = rng.integers(3, 293, n - 1)
        tokens[b, 1:n] = body
        labels[b, :n - 1] = body
        labels[b, n - 1] = 2
    seq_lens = (tokens != 0).sum(1).astype(np.int32)
    classes = rng.integers(0, 2, rows).astype(np.int32)
    return {"tokens": tokens, "seq_lens": seq_lens, "classes": classes, "labels": labels}


def tensors(batch):
    return [torch.as_tensor(batch[k]).long() for k in ("tokens", "seq_lens", "classes", "labels")]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Seeded JAX parameters, the batches and the configs, written for the
    workers."""
    folder = tmp_path_factory.mktemp("parallel")
    cfg = jax_config()
    jparams = init_params(make_model(cfg), jax.random.key(0), max_seq_len=L)
    flat = {"/".join(k): np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(jparams)).items()}
    np.savez(folder / "params.npz", **flat)
    for name, c in (("config", cfg), ("config_core", jax_config(route="core")),
                    ("config_flash", jax_config(route="flash")),
                    ("config_dropout", jax_config(0.1)),
                    ("config_ring", jax_config(0.1, ring=True))):
        (folder / f"{name}.json").write_text(json.dumps(dataclasses.asdict(c)))
    np.savez(folder / "batch.npz", **make_batch(1))
    for i in range(3):
        np.savez(folder / f"train{i}.npz", **make_batch(10 + i))
    model = torch_model(cfg, jparams)
    grad = np.random.default_rng(5).normal(size=sum(p.numel() for p in model.parameters()))
    np.savez(folder / "clip_grad.npz", grad=grad.astype(np.float32))
    (folder / "process_spec.json").write_text(json.dumps(PROCESS_SPEC))
    return folder, cfg, jparams


@pytest.fixture(scope="module")
def worker_results(setup):
    """Two gloo ranks running every scenario of torch_dist_worker.py."""
    folder = setup[0]
    spec = folder / "spec.json"
    spec.write_text(json.dumps({"folder": str(folder), "scenarios": [
        "tp_grads", "tp_grads_core", "tp_grads_flash", "clip", "dp_train", "tp_train", "ring_train", "process_layer"]}))
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, WORKER, str(spec), str(r), "2", port],
                              cwd=REPO, env=child_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
    return folder


def result(folder, name):
    with np.load(folder / f"{name}.npz") as z:
        return {k: z[k] for k in z.files}


# ---- the rules --------------------------------------------------------------


@pytest.mark.parametrize("heads,size,tp", [(4, 32, 2), (4, 32, 3), (6, 48, 4)])
def test_param_spec_and_shards_match_jax(cpu_devices, heads, size, tp):
    """The port's rule for each parameter is the JAX rule on the same flax
    path (column-parallel: weight dim 0 = kernel dim 1; row-parallel: weight
    dim 1 = kernel dim 0), and each rank's slice is the JAX shard on its
    device, indivisible dims replicated; shard_model replicates attention
    whose heads tp does not divide (heads are sliced whole)."""
    cfg = jax_config(heads=heads, size=size)
    jparams = init_params(make_model(cfg), jax.random.key(1), max_seq_len=L)
    mesh = jmesh.make_mesh(cpu_devices[:tp], tp=tp)
    shardings = traverse_util.flatten_dict(jmesh.param_shardings(jparams, mesh))
    arrays = traverse_util.flatten_dict(jax.device_get(jparams))
    model = torch_model(cfg, jparams)
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    flax_of = {n: "/".join(path) for n, path in zip(
        sd, (p for p, *_ in _flax_paths(model)))}
    for rank in range(tp):
        local = tmesh.shard_params(sd, types.SimpleNamespace(tp=tp, model_rank=rank))
        for name, x in local.items():
            path = tuple(flax_of[name].split("/"))
            jspec = jmesh.param_spec(flax_of[name])
            kernel = path[-1] == "kernel"
            want_dim = None
            if len(jspec):
                want_dim = (1 - list(jspec).index("model")) if kernel else 0
            assert tmesh.param_spec(name) == want_dim, name
            index = shardings[path].addressable_devices_indices_map(arrays[path].shape)[
                cpu_devices[rank]]
            shard = np.asarray(arrays[path])[index]
            np.testing.assert_array_equal(x.numpy(), shard.T if kernel else shard)
    layout = tmesh.shard_model(torch_model(cfg, jparams),
                               types.SimpleNamespace(tp=tp, model_rank=0))
    for s in layout:
        attention = any(w in s.name for w in ("w_q", "w_k", "w_v", "w_o"))
        if attention and heads % tp:
            assert s.dim is None, s.name


def _flax_paths(model):
    from musicstyletransfer_torch.convert import _flax_leaves

    return [(name.split("/"), p, t) for name, p, t in _flax_leaves(model)]


# ---- the process layer -------------------------------------------------------


def test_process_sharded_batches_match_jax(worker_results):
    """dp=2: each rank's rows of every batch of an epoch (the last one
    wrap-padded) are the JAX ProcessShardedDataset's for its process, with
    its n_valid; make_global_batch puts them back in data-rank order."""
    got = result(worker_results, "process_layer")
    melodies = JLoader(CORPUS, PROCESS_SPEC["L"]).melodies
    full = list(JMelodyDataset(PROCESS_SPEC["batch"], PROCESS_SPEC["L"], melodies))
    per_rank = [list(jdist.ProcessShardedDataset(
        JMelodyDataset(PROCESS_SPEC["batch"], PROCESS_SPEC["L"], melodies),
        jdist.ProcessInfo(index=r, count=2))) for r in range(2)]
    assert got["tokens"].shape[0] == len(full) > 1 and int(got["local_rows"]) == 4
    assert full[-1].num_valid < PROCESS_SPEC["batch"]  # the wrap-padded batch is covered
    for i, batch in enumerate(full):
        np.testing.assert_array_equal(got["tokens"][i], batch.tokens)
        np.testing.assert_array_equal(
            got["tokens"][i], np.concatenate([per_rank[r][i].tokens for r in range(2)]))
        assert list(got["n_valid"][i]) == [per_rank[r][i].num_valid for r in range(2)]


def test_process_infos_and_assert_in_sync(worker_results):
    """mesh_process_info and the data axis's info are each rank's (index,
    count); assert_in_sync passes on an agreed value and raises, naming the
    shared-storage cause, on one that differs by rank."""
    got = result(worker_results, "process_layer")
    np.testing.assert_array_equal(got["infos"], [[0, 2, 0, 2], [1, 2, 1, 2]])
    assert "processes disagree on the rank" in str(got["caught"])
    assert "shared storage" in str(got["caught"])


# ---- tp=2 against JAX --------------------------------------------------------


@pytest.mark.parametrize("route", list(ROUTES))
def test_tp2_forward_loss_and_grads_match_jax_mesh(setup, worker_results, cpu_devices, route):
    """Two ranks at tp=2 (heads and FFN columns sliced, Megatron's
    collectives) against JAX on a (1, 2) mesh with the TP rules, on each
    attention route: dense, the core (the interleaved qkv built from each
    rank's whole heads; JAX's attention_core_tp in interpret mode) and
    flash."""
    folder, _, jparams = setup
    cfg = jax_config(route=route)
    batch = make_batch(1)
    jmodel = make_model(cfg)
    mesh = jmesh.make_mesh(cpu_devices[:2], tp=2)

    def loss_fn(p):
        logits, mu, logvar = jmodel.apply({"params": p}, *(jnp.asarray(batch[k]) for k in (
            "tokens", "seq_lens", "classes")), train=False)
        total, _ = jax_vae_loss(logits, jnp.asarray(batch["labels"]), mu, logvar,
                                kl_weight=0.5)
        return total, (logits, mu)

    with jmesh.use_mesh(mesh):
        (total, (logits, mu)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jmesh.shard_params(jparams, mesh))
    got = result(worker_results, "tp_grads" if route == "dense" else f"tp_grads_{route}")
    assert len(got["sharded"]) > 0
    np.testing.assert_allclose(got["logits"], np.asarray(logits), atol=1e-4)
    np.testing.assert_allclose(got["mu"], np.asarray(mu), atol=1e-5)
    np.testing.assert_allclose(got["loss"], np.asarray(total), atol=1e-5)
    model = torch_model(cfg, jparams)
    np.testing.assert_allclose(got["grad"], port_flat(jax.device_get(grads), model), atol=1e-5)


def test_tp2_clip_by_global_norm_matches_optax(setup, worker_results):
    """clip_global_norm at tp=2 sums the sharded leaves' squares over the
    model group and counts the replicated ones once: optax's global norm."""
    folder, cfg, jparams = setup
    model = torch_model(cfg, jparams)
    with np.load(folder / "clip_grad.npz") as z:
        flat = z["grad"]
    sd, offset = {}, 0
    for name, p in model.named_parameters():
        sd[name] = flat[offset:offset + p.numel()].reshape(p.shape)
        offset += p.numel()
    names = {n: tuple(path) for n, (path, _, _) in zip(sd, _flax_paths(model))}
    gtree = traverse_util.unflatten_dict(
        {names[n]: jnp.asarray(v.T if names[n][-1] == "kernel" else v) for n, v in sd.items()})
    tx = optax.chain(optax.clip_by_global_norm(0.05), optax.sgd(0.1))
    updates, _ = tx.update(gtree, tx.init(jparams), jparams)
    want = optax.apply_updates(jparams, updates)
    got = result(worker_results, "clip")
    np.testing.assert_allclose(got["norm"], float(optax.global_norm(gtree)), rtol=1e-6)
    np.testing.assert_allclose(got["params"], port_flat(jax.device_get(want), model), atol=1e-6)


# ---- sharded training against one process ------------------------------------


def one_process(setup, config_name):
    folder, _, jparams = setup
    cfg = jax_config(0.1, ring=config_name == "ring")
    model = torch_model(cfg, jparams)
    trainer = Trainer(TrainConfig(optimizer=OptimizerConfig(
        "sgd", "momentum:0.9,clip_global_norm:1.0,skip_nonfinite:3", 0.05), seed=3,
        prefetch=0, log_param_grad_norms=True), model)
    for i in range(3):
        trainer.train_batches([tensors(make_batch(10 + i))])
    return (trainer.optimizer.flat.numpy(),
            (trainer.state.sums / trainer.state.counts).numpy())


@pytest.mark.parametrize("scenario", ["dp_train", "tp_train", "ring_train"])
def test_sharded_training_equals_one_process(setup, worker_results, scenario):
    """3 SGD steps with dropout, the global-norm clip and the non-finite
    guard: DP=2 (each rank its rows), tp=2 (dropout masks of the FFN hidden
    cut by column) and ring attention over 2 ranks (the time axis in chunks)
    against one process on the global batch: the masks and eps are drawn at
    the global shape, so the runs agree; so do the logged metrics, the
    per-parameter gradient norms among them, reduced over the ranks."""
    params, means = one_process(setup, "ring" if scenario == "ring_train" else "dropout")
    got = result(worker_results, scenario)
    np.testing.assert_allclose(got["params"], params, atol=1e-5)
    # the metrics reduced over the ranks; atol for the norms of float32 noise
    # (the key bias's gradient, which softmax ignores)
    np.testing.assert_allclose(got["means"], means, rtol=1e-5, atol=1e-6)


# ---- cli.main ----------------------------------------------------------------


@pytest.mark.parametrize("script,module", [
    ("train-distributed.sh", "main"), ("train-vae-long.sh", "main"), ("train-vae.sh", "main"),
    ("train-vae-wide.sh", "main"), ("train-gan.sh", "gan")])
def test_recipe_argv_keeps_paths_and_drops_launcher_variables(script, module):
    """chip_smoke.recipe_argv, which drives every recipe on the card: the
    script's data, model and sample paths are replaced (``--data "$DATA"``
    too), shell defaults taken, and the launcher's own variables
    (train-distributed.sh's --dist-* "$COORD" ...) left out."""
    import chip_smoke

    argv = chip_smoke.recipe_argv(script, "D", "M", "O", required=(), module=module)
    for flag, value in (("--data", "D"), ("--model-output", "M"), ("--out-samples", "O")):
        assert argv[argv.index(flag) + 1] == value, flag
    assert not any("$" in a for a in argv), argv
    assert not any(a.startswith("--dist-") for a in argv), argv


def train_argv(corpus, model, epochs):
    return ["--cpu", "--data", corpus, "--model-output", model, "--logdir", model + "-log",
            "--batch-size", "4", "--max-seq-len", "8", "--validation-split", "0",
            "--validation-data", corpus,
            "--epochs", str(epochs), "--checkpoint-frequency", "1000", "--log-every", "1",
            "--e-n-layers", "1", "--e-rnn-hidden-dim", "32", "--e-num-heads", "4",
            "--e-dropout", "0.1", "--d-dropout", "0.1", "--latent-dim", "16",
            "--d-rnn-hidden-dim", "32", "--dtype", "float32", "--optimizer", "sgd",
            "--optimizer-params", "momentum:0.9,clip_global_norm:1.0",
            "--learning-rate", "0.05", "--gen-health-rows", "0", "--prefetch", "0"]


def launch(argv, world):
    """cli.main as ``world`` processes (--dist-* on gloo) or one process."""
    cmd = [sys.executable, "-m", "musicstyletransfer_torch.cli.main", *argv]
    if world == 1:
        return [subprocess.Popen(cmd, cwd=REPO, env=child_env(), stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)]
    port = str(free_port())
    return [subprocess.Popen(cmd + ["--dist-coordinator", f"127.0.0.1:{port}",
                                    "--dist-num-processes", str(world),
                                    "--dist-process-id", str(r)],
                             cwd=REPO, env=child_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


def wait(procs):
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
        outs.append(out)
    return outs


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """cli.main runs on a two-file corpus: one process for 1 and 2 epochs;
    two processes at --tp 2 for 1 and for 2 epochs, and with
    --ring-attention --tp 2 for 1; then the 1-epoch tp=2 run resumed for a
    second epoch."""
    root = tmp_path_factory.mktemp("cli")
    corpus = root / "corpus"
    for cls, name in [("bass", "Until_It_Sleeps_2_Bass-Guitar.mid"),
                      ("guitar", "Metal_Militia_Guitar-3.mid")]:
        os.makedirs(corpus / cls)
        shutil.copy(os.path.join(CORPUS, cls, name), corpus / cls / name)
    runs = {"one1": ([], 1, 1), "one2": ([], 1, 2), "tp2_1": (["--tp", "2"], 2, 1),
            "tp2_2": (["--tp", "2"], 2, 2),
            "ring2_1": (["--tp", "2", "--ring-attention"], 2, 1)}
    procs = {k: launch(train_argv(str(corpus), str(root / k), epochs) + extra, world)
             for k, (extra, world, epochs) in runs.items()}
    logs = {k: wait(v) for k, v in procs.items()}
    logs["resumed"] = wait(launch(train_argv(str(corpus), str(root / "tp2_1"), 1)
                                  + ["--tp", "2"], 2))
    return root, corpus, logs


def final_params(folder, index=-1):
    return ckpt.restore_checkpoint(str(folder), ckpt.checkpoint_indices(str(folder))[index])


def test_cli_tp2_and_ring_tp2_equal_one_process(cli_runs):
    """cli.main at --tp 2 and at --ring-attention --tp 2, two gloo
    processes, writes the parameters one process writes (1e-5), and only
    the primary logs."""
    root, _, logs = cli_runs
    one = final_params(root / "one1")
    for run in ("tp2_1", "ring2_1"):
        got = final_params(root / run, 0)  # tp2_1 was resumed since: its first checkpoint
        assert got["step"] == one["step"] > 0
        np.testing.assert_allclose(got["params"].numpy(), one["params"].numpy(), atol=1e-5)
        assert "Validation:" in logs[run][0] and "Validation:" not in logs[run][1]
        assert "Mesh(data=1, model=2" in logs[run][1]


def test_two_process_run_resumed_equals_uninterrupted(cli_runs):
    """A 2-process tp=2 run stopped after its checkpoint of epoch 1 and
    resumed for epoch 2 (the checkpoint's full state sharded again, the step
    agreed) ends where the uninterrupted 2-epoch run ends, bit for bit, and
    both within 1e-5 of one process."""
    root, _, logs = cli_runs
    assert "Resuming training" in logs["resumed"][0]
    resumed, straight = final_params(root / "tp2_1"), final_params(root / "tp2_2")
    assert resumed["step"] == straight["step"]
    assert torch.equal(resumed["params"], straight["params"])
    for k, v in straight["optimizer"].items():
        assert torch.equal(resumed["optimizer"][k], v), k
    np.testing.assert_allclose(straight["params"].numpy(),
                               final_params(root / "one2")["params"].numpy(), atol=1e-5)


def test_tp2_checkpoint_restored_by_one_process(cli_runs, tmp_path):
    """The tp=2 checkpoint holds whole tensors: a single process's
    load_inference_model reads its parameters, its torch/ export holds the
    same, and cli.sample writes MIDI from it."""
    root, corpus, _ = cli_runs
    folder = root / "tp2_2"
    state = final_params(folder)
    model = load_inference_model(str(folder), -1, torch.device("cpu"))
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    assert torch.equal(flat, state["params"])
    export = tmp_path / "export"
    shutil.copytree(folder / ckpt.EXPORT_DIR, export / ckpt.EXPORT_DIR)
    exported = load_inference_model(str(export), -1, torch.device("cpu"))
    assert all(torch.equal(a, b) for a, b in zip(exported.parameters(), model.parameters()))
    out = tmp_path / "samples"
    cli_sample.main(["--cpu", "--model-output", str(folder), "--data", str(corpus),
                     "--out-samples", str(out), "--batch-size", "4", "--max-seq-len", "8"])
    assert any(n.endswith(".mid") for n in os.listdir(out))

