"""One rank of the port's multi-process CPU checks (gloo), JAX-free:

    python tests/torch_dist_worker.py SPEC.json RANK WORLD PORT

``SPEC.json`` names the scenarios to run, in order, and the folder of their
inputs and outputs; each scenario builds the mesh it needs over the one
world and writes ``<name>.npz`` from rank 0. ``tests/test_torch_parallel.py``
and ``tests/test_torch_ring_attention.py`` launch two of these and hold the
results against the JAX package and against one process.
"""

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from musicstyletransfer_torch.convert import load_npz, params_from_jax  # noqa: E402
from musicstyletransfer_torch.data import Loader, MelodyDataset  # noqa: E402
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


SCENARIOS = {f.__name__: f for f in (tp_grads, tp_grads_core, tp_grads_flash, clip, dp_train, tp_train, ring_train, ring_op,
                                     process_layer)}


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
