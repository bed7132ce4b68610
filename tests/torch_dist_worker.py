"""One rank of the port's multi-process CPU checks (gloo), JAX-free:

    python tests/torch_dist_worker.py SPEC.json RANK WORLD PORT

``SPEC.json`` names the scenarios to run, in order, and the folder of their
inputs and outputs; each scenario builds the mesh it needs over the one
world and writes ``<name>.npz`` from rank 0. ``tests/test_torch_parallel.py``,
``tests/test_torch_ring_attention.py``, ``tests/test_torch_sharded.py``,
``tests/test_torch_gan.py`` and ``tests/test_torch_pipeline.py`` launch
two of these and hold the results against the JAX package and against one
process.
"""

import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from musicstyletransfer_torch.convert import (load_npz, params_from_jax,  # noqa: E402
                                              params_to_jax)
from musicstyletransfer_torch.data import Loader, MelodyDataset  # noqa: E402
from musicstyletransfer_torch.data.dataset import Batch, Dataset  # noqa: E402
from musicstyletransfer_torch.inference import service as service_mod  # noqa: E402
from musicstyletransfer_torch.inference import sharded as sharded_mod  # noqa: E402
from musicstyletransfer_torch.inference.decode import decode_stepwise  # noqa: E402
from musicstyletransfer_torch.inference.sampler import load_inference_model  # noqa: E402
from musicstyletransfer_torch.inference.service import StyleTransferService  # noqa: E402
from musicstyletransfer_torch.inference.sharded import (  # noqa: E402
    prepare_params, sharded_sample_sequences, sharded_style_transfer_all_classes)
from musicstyletransfer_torch.inference.streaming import StreamingTransferEngine  # noqa: E402
from musicstyletransfer_torch.models.config import GANConfig  # noqa: E402
from musicstyletransfer_torch.models.gan import make_discriminator, make_generator  # noqa: E402
from musicstyletransfer_torch.models import StyleVAE  # noqa: E402
from musicstyletransfer_torch.models.config import ModelConfig  # noqa: E402
from musicstyletransfer_torch.ops.ring_attention import ring_attention_sharded  # noqa: E402
from musicstyletransfer_torch.parallel import (ProcessShardedDataset,  # noqa: E402
                                               assert_in_sync, initialize_distributed,
                                               make_global_batch, make_mesh,
                                               mesh_process_info, shard_batch, shard_model,
                                               use_mesh)
from musicstyletransfer_torch.parallel.distributed import data_process_info  # noqa: E402
from musicstyletransfer_torch.parallel.mesh import (FlatSync, gather_flat,  # noqa: E402
                                                    shard_flat)
from musicstyletransfer_torch.training.gan_trainer import (GANSteps,  # noqa: E402
                                                           GANTrainConfig, GANTrainer)
from musicstyletransfer_torch.training.loss import vae_loss  # noqa: E402
from musicstyletransfer_torch.training.optimizer import Optimizer, OptimizerConfig  # noqa: E402
from musicstyletransfer_torch.training.trainer import TrainConfig, Trainer  # noqa: E402


def load_model(folder, config_name="config.json"):
    with open(os.path.join(folder, config_name)) as f:
        config = ModelConfig.from_dict(json.load(f))
    model = StyleVAE(config)
    model.load_state_dict(params_from_jax(load_npz(os.path.join(folder, "params.npz"))))
    return model


def batch(folder, name="batch.npz"):
    with np.load(os.path.join(folder, name)) as z:
        return [torch.as_tensor(z[k]).long() for k in ("tokens", "seq_lens", "classes",
                                                        "labels")]


def tp_grads(folder, rank, config_name="config.json"):
    """tp=2: logits, loss and the gathered gradient of an eval-mode step."""
    model = load_model(folder, config_name).eval()
    mesh = make_mesh(2)
    layout = shard_model(model, mesh)
    tokens, seq_lens, classes, labels = batch(folder)
    with use_mesh(mesh):
        logits, mu, logvar = model(tokens, seq_lens, classes)
        total, _ = vae_loss(logits, labels, mu, logvar, kl_weight=0.5)
        total.backward()
    grad = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    full = gather_flat(grad, layout, mesh)
    sharded = [s.name for s in layout if s.dim is not None]
    return {"logits": logits.detach().numpy(), "mu": mu.detach().numpy(),
            "loss": total.detach().numpy(), "grad": full.numpy(),
            "sharded": np.asarray(sharded)}


def tp_grads_core(folder, rank):
    """tp_grads on the attention core's route (K2/K3 on each rank's heads)."""
    return tp_grads(folder, rank, "config_core.json")


def tp_grads_flash(folder, rank):
    """tp_grads on the flash route (K4/K5 on each rank's heads)."""
    return tp_grads(folder, rank, "config_flash.json")


def clip(folder, rank):
    """tp=2: one SGD step with clip_global_norm from a given full gradient."""
    model = load_model(folder)
    mesh = make_mesh(2)
    layout = shard_model(model, mesh)
    opt = Optimizer(list(model.parameters()),
                    OptimizerConfig("sgd", "clip_global_norm:0.05", 0.1),
                    sync=FlatSync(mesh, layout, torch.device("cpu")))
    with np.load(os.path.join(folder, "clip_grad.npz")) as z:
        grad = shard_flat(torch.as_tensor(z["grad"]), layout, mesh)
    norm = torch.sqrt(opt.sq_sum(grad))
    opt.step(grad)
    return {"params": gather_flat(opt.flat, layout, mesh).numpy(), "norm": norm.numpy()}


def _train(folder, rank, tp, config_name, rows):
    model = load_model(folder, config_name)
    mesh = make_mesh(tp)
    cfg = TrainConfig(optimizer=OptimizerConfig(
        "sgd", "momentum:0.9,clip_global_norm:1.0,skip_nonfinite:3", 0.05), seed=3,
        prefetch=0, log_param_grad_norms=True)
    trainer = Trainer(cfg, model, mesh=mesh)
    for i in range(3):
        tensors = batch(folder, f"train{i}.npz")
        trainer.train_batches([shard_batch(tensors, mesh) if rows else tensors])
    sums, counts = trainer._reduce_pairs(trainer.state.sums, trainer.state.counts)
    return {"params": trainer._full(trainer.optimizer.flat).numpy(),
            "means": (sums / counts).numpy()}


def dp_train(folder, rank):
    return _train(folder, rank, 1, "config_dropout.json", rows=True)


def tp_train(folder, rank):
    return _train(folder, rank, 2, "config_dropout.json", rows=False)


def ring_train(folder, rank):
    return _train(folder, rank, 2, "config_ring.json", rows=False)


def ring_op(folder, rank):
    """ring_attention_sharded over the model axis of 2: out and the
    gradients of sum(out * w), for each case of ring_cases.npz."""
    mesh = make_mesh(2)
    out = {}
    with np.load(os.path.join(folder, "ring_cases.npz")) as z:
        cases = json.loads(str(z["cases"]))
        for i, case in enumerate(cases):
            q, k, v, w = (torch.as_tensor(z[f"{n}{i}"]).requires_grad_(n != "w")
                          for n in "qkvw")
            o = ring_attention_sharded(q, k, v, torch.as_tensor(z[f"lens{i}"]),
                                       causal=case["causal"], mesh=mesh)
            (o * w).sum().backward()
            out[f"out{i}"] = o.detach().numpy()
            for n, x in (("dq", q), ("dk", k), ("dv", v)):
                out[f"{n}{i}"] = x.grad.numpy()
    return out


def process_layer(folder, rank):
    """dp=2: every rank iterates one epoch of the corpus through
    ProcessShardedDataset; make_global_batch gathers each batch's rows and
    each rank's n_valid back; the process infos; assert_in_sync with an
    agreed value and with a value that differs by rank."""
    mesh = make_mesh(1)
    with open(os.path.join(folder, "process_spec.json")) as f:
        spec = json.load(f)
    melodies = Loader(spec["corpus"], spec["L"]).melodies
    dataset = ProcessShardedDataset(MelodyDataset(spec["batch"], spec["L"], melodies),
                                    data_process_info(mesh))
    tokens, n_valid = [], []
    for b in dataset:
        tokens.append(make_global_batch(torch.as_tensor(b.tokens), mesh))
        n_valid.append(make_global_batch(torch.tensor([b.num_valid]), mesh))
    info = [mesh_process_info(mesh), data_process_info(mesh)]
    infos = make_global_batch(torch.tensor([[i.index, i.count] for i in info]).reshape(1, -1),
                              mesh)
    assert_in_sync(mesh, 7.0, "an agreed value")
    try:
        assert_in_sync(mesh, float(rank), "the rank")
        caught = ""
    except RuntimeError as e:
        caught = str(e)
    return {"tokens": torch.stack(tokens).numpy(), "n_valid": torch.stack(n_valid).numpy(),
            "local_rows": np.asarray(dataset.local_batch_size), "infos": infos.numpy(),
            "caught": np.asarray(caught)}


# ---- sharded inference (inference/sharded.py, the service, the engine) ----

CPU = torch.device("cpu")


def sharded_spec(folder):
    with open(os.path.join(folder, "sharded.json")) as f:
        spec = json.load(f)
    with np.load(os.path.join(folder, "sharded_inputs.npz")) as z:
        inputs = {k: torch.as_tensor(z[k]) for k in z.files}
    return spec, inputs


def counting(module, name):
    """Count the calls of ``module.name`` (into the returned list)."""
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    setattr(module, name, counted)
    return calls


def _decode_cases(spec, x, model, mesh, cases):
    args = (model, x["tokens"], x["seq_lens"], x["classes"], spec["max_len"])
    out = {}
    for name, kw in cases:
        seqs, scores = sharded_sample_sequences(*args, torch.Generator().manual_seed(1), mesh,
                                                **kw)
        out[f"{name}_seqs"], out[f"{name}_scores"] = seqs.numpy(), scores.numpy()
    return out


def sharded_dp(folder, rank):
    """dp=2: greedy through the route the CPU picks (the step loop), K1's
    plain version forced and the loop forced; sampled; the all-classes
    transfer greedy; K1 calls a rank a call."""
    spec, x = sharded_spec(folder)
    model = load_inference_model(spec["model"], -1, CPU)
    mesh = make_mesh(1)
    k1 = counting(sharded_mod, "fused_decode")
    out = {}
    for name, kw in (("auto", {}), ("fused", {"use_fused": True}),
                     ("loop", {"use_fused": False})):
        before = len(k1)
        out.update(_decode_cases(spec, x, model, mesh, [(name, dict(kw, greedy=True))]))
        out[f"{name}_k1"] = np.asarray(len(k1) - before)
    out.update(_decode_cases(spec, x, model, mesh, [("sampled", {}),
                                                    ("sampled_fused", {"use_fused": True})]))
    seqs, scores = sharded_style_transfer_all_classes(
        model, x["tokens"], x["seq_lens"], spec["max_len"], spec["classes"],
        torch.Generator().manual_seed(2), mesh, greedy=True, params_on_mesh=True)
    out["all_seqs"], out["all_scores"] = seqs.numpy(), scores.numpy()
    out["divides_seqs"] = _decode_cases(
        spec, {k: v[:4] for k, v in x.items()}, model, mesh, [("d", {})])["d_seqs"]
    return out


def sharded_tp(folder, rank):
    """tp=2: the model split by the TP rules; greedy decode through the
    sharded call and teacher-forced logits of the cached step (its cache at
    the rank's heads); use_fused=True refused."""
    spec, x = sharded_spec(folder)
    model = load_inference_model(spec["model"], -1, CPU)
    mesh = make_mesh(2)
    prepare_params(model, mesh)
    out = _decode_cases(spec, x, model, mesh, [("greedy", {"greedy": True,
                                                            "params_on_mesh": True})])
    with use_mesh(mesh), torch.inference_mode():
        z, _ = model.encode(x["tokens"], x["seq_lens"], x["classes"])
        _, _, logits = decode_stepwise(model, z, x["classes"], spec["max_len"], 0, mode="forced",
                                       forced_tokens=x["forced"])
    out["forced_logits"] = logits.numpy()
    out["local_heads"] = np.asarray(model.decoder.decoder.layers[0].attention.local_heads)
    try:
        sharded_sample_sequences(model, x["tokens"], x["seq_lens"], x["classes"],
                                 spec["max_len"], torch.Generator(), mesh, use_fused=True)
        out["refused"] = np.asarray("")
    except ValueError as e:
        out["refused"] = np.asarray(str(e))
    return out


def _requests(spec):
    return [bytes.fromhex(h) for h in spec["requests"]]


def _tokens_by_class(results):
    return {f"r{i}_c{c}": np.asarray(t) for i, r in enumerate(results)
            for c, t in r.tokens_by_class.items()}


def service_dp(folder, rank):
    """dp=2: StyleTransferService(mesh=, greedy=True): a direct micro-batch
    of every request, then one request through the threaded loop; the
    follower runs start()/stop(). Sharded calls a rank."""
    spec, _ = sharded_spec(folder)
    mesh = make_mesh(1)
    calls = counting(service_mod, "sharded_style_transfer_all_classes")
    svc = StyleTransferService(spec["model"], checkpoint=-1, batch_size=4, max_seq_len=8,
                               mesh=mesh, greedy=True)
    out = {}
    if rank == 0:
        requests = _requests(spec)
        out.update(_tokens_by_class(svc.transfer_tokens(
            [svc._tokens_from_midi(m) for m in requests])))
        svc.start()
        got = []
        svc.enqueue(requests[0], got.append)
        deadline = time.time() + 60
        while not got and time.time() < deadline:
            time.sleep(0.01)
        svc.stop()
        out.update({f"loop_{k}": v for k, v in _tokens_by_class(got).items()})
    else:
        svc.start()
        svc.stop()
    counts = [torch.tensor([len(calls)])]
    parts = [torch.zeros(1, dtype=torch.int64) for _ in range(mesh.world)]
    torch.distributed.all_gather(parts, counts[0])
    out["calls"] = torch.cat(parts).numpy()
    return out


def _engine_run(spec, mesh, rank, **kw):
    eng = StreamingTransferEngine(spec["model"], checkpoint=-1, slots=8, max_seq_len=8,
                                  segment_steps=4, admit_size=4, mesh=mesh, **kw)
    if rank != 0:
        eng.serve_follower()
        return {}
    results = [eng.submit_midi(m) for m in _requests(spec)]
    eng.stop()
    return _tokens_by_class(results)


def engine_dp(folder, rank):
    """dp=2: the engine's slots over the data axis, greedy and sampled."""
    spec, _ = sharded_spec(folder)
    mesh = make_mesh(1)
    out = {f"greedy_{k}": v for k, v in _engine_run(spec, mesh, rank, greedy=True).items()}
    out.update({f"sampled_{k}": v for k, v in _engine_run(spec, mesh, rank, seed=3).items()})
    return out


def engine_tp(folder, rank):
    """tp=2: the engine's ragged step on each rank's heads, greedy."""
    spec, _ = sharded_spec(folder)
    return _engine_run(spec, make_mesh(2), rank, greedy=True)


# ---- GAN data parallelism (training/gan_trainer.py) ------------------------


class Batches(Dataset):
    def __init__(self, x, n):
        super().__init__(n)
        self.x, self.n = x, n

    def num_classes(self):
        return 3

    def num_tokens(self):
        return int(self.x["vocab"])

    def __iter__(self):
        for i in range(self.x["fit_tokens"].shape[0] // self.n):
            t = self.x["fit_tokens"][i * self.n:(i + 1) * self.n].numpy()
            c = self.x["fit_classes"][i * self.n:(i + 1) * self.n].numpy()
            yield Batch(t, np.full(self.n, t.shape[1], np.int32), c, t)


def gan_models(folder):
    with open(os.path.join(folder, "gan_config.json")) as f:
        config = GANConfig.from_dict(json.load(f))
    gen, disc = make_generator(config), make_discriminator(config)
    gen.load_state_dict(params_from_jax(load_npz(os.path.join(folder, "gan_g.npz"))))
    disc.load_state_dict(params_from_jax(load_npz(os.path.join(folder, "gan_d.npz"))))
    return config, gen, disc


def gan_dp(folder, rank):
    """dp=2: two D steps and a G step on the rank's rows of the global batch
    and of the JAX trainer's noise (GANSteps(mesh=)); then GANTrainer(mesh=)
    fit on global batches."""
    with np.load(os.path.join(folder, "gan_inputs.npz")) as z:
        x = {k: torch.as_tensor(z[k]) for k in z.files}
    mesh = make_mesh(1)
    config, gen, disc = gan_models(folder)
    tc = GANTrainConfig(d_learning_rate=1e-3, g_learning_rate=1e-3)
    steps = GANSteps(config, tc, gen, disc, torch.Generator().manual_seed(0), mesh)
    tokens, classes = shard_batch([x["tokens"], x["classes"]], mesh)
    for i in range(2):
        steps.d_step(tokens, classes, noise=shard_batch([x[f"noise_d{i}"]], mesh)[0])
    steps.g_step(classes, noise=shard_batch([x["noise_g"]], mesh)[0])
    out = {f"g/{k}": v for k, v in params_to_jax(gen).items()}
    out.update({f"d/{k}": v for k, v in params_to_jax(disc).items()})
    out.update({f"m/{k}": np.asarray(v) for k, v in steps.metrics().items()})
    trainer = GANTrainer(config, GANTrainConfig(discriminator_update_steps=2, log_every=2,
                                                checkpoint_frequency=0, sampling_frequency=0,
                                                logdir=os.path.join(folder, "gan_fit_log")),
                         mesh=mesh)
    fit = trainer.fit(Batches(x, 8), os.path.join(folder, "gan_fit"), epochs=2)
    out.update({f"fit_g/{k}": v for k, v in params_to_jax(trainer.gen).items()})
    out.update({f"fit_m/{k}": np.asarray(v) for k, v in fit.items()})
    return out


# ---- pipeline parallelism (parallel/pipeline.py, transformer_pipeline.py) ----


def pipeline(folder, rank):
    """pp=2 over the model axis, through the real hops with autograd: the MLP
    stages' output and the gradients of sum(out * w), and a TransformerStack
    (the long recipe's ring_attention set, the flash route's plain versions)
    pipelined under use_mesh(mesh): output and the gradients of
    mean(out ** 2), the stage parameters' gradients summed over the model
    group (each rank holds its own stage's), x's and final_ln's as rank 0
    holds them, taken with torch.autograd.grad; the calls of ring_attention
    and scatter_seq."""
    from musicstyletransfer_torch.models import transformer as tmod
    from musicstyletransfer_torch.models.config import TransformerConfig
    from musicstyletransfer_torch.parallel import (pipeline_apply,
                                                   pipeline_transformer_stack)

    mesh = make_mesh(2)
    with np.load(os.path.join(folder, "pipeline_inputs.npz")) as z:
        x = {k: torch.as_tensor(z[k]) for k in z.files}
    params = {k: x[k].clone().requires_grad_() for k in ("w", "b")}
    xm = x["x"].clone().requires_grad_()
    out = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]), params, xm, mesh=mesh,
                         microbatches=4)
    (out * x["wt"]).sum().backward()
    grads = torch.cat([params["w"].grad.reshape(-1), params["b"].grad.reshape(-1)])
    mesh.all_reduce_model_sum_(grads)
    res = {"mlp_out": out.detach().numpy(), "mlp_grads": grads.numpy(),
           "mlp_gx": xm.grad.numpy() if xm.grad is not None else np.zeros(0)}
    with open(os.path.join(folder, "pipeline_stack.json")) as f:
        spec = json.load(f)
    stack = tmod.TransformerStack(TransformerConfig.from_dict(spec["config"]), spec["causal"],
                                  torch.float32)
    stack.load_state_dict(params_from_jax(load_npz(os.path.join(folder, "stack.npz"))))
    ring, scatter = counting(tmod, "ring_attention"), counting(tmod, "scatter_seq")
    hs = x["hx"].clone().requires_grad_()
    with use_mesh(mesh):
        o = pipeline_transformer_stack(stack, hs, x["mask"].bool(), mesh=mesh,
                                       microbatches=2)
    # torch.autograd.grad runs only what leads to the inputs asked about: on
    # rank 1 the first hop carried zeros, and its backward must run all the same
    names, params = zip(*stack.named_parameters())
    grads = torch.autograd.grad(o.pow(2).mean(), (*params, hs))
    for name, g in zip(names, grads):
        g = g.clone()
        if name.startswith("layers."):
            mesh.all_reduce_model_sum_(g)
        res[f"stack_grad/{name}"] = g.numpy()
    res.update({"stack_out": o.detach().numpy(), "calls": np.asarray([len(ring), len(scatter)]),
                "stack_gx": grads[-1].numpy()})
    return res


SCENARIOS = {f.__name__: f for f in (tp_grads, tp_grads_core, tp_grads_flash, clip, dp_train,
                                     tp_train, ring_train, ring_op, process_layer, sharded_dp,
                                     sharded_tp, service_dp, engine_dp, engine_tp, gan_dp,
                                     pipeline)}


def main():
    spec_path, rank, world, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", world, rank)
    try:
        for name in spec["scenarios"]:
            result = SCENARIOS[name](spec["folder"], rank)
            if rank == 0:
                np.savez(os.path.join(spec["folder"], f"{name}.npz"), **result)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
