"""The port's packages export a counterpart of every public name of the JAX
package's ``training``, ``ops``, ``models`` and ``parallel`` (their
``__all__``), except the names listed in ``NO_TORCH_MEANING`` with their
reasons; and the checkpoint helpers that were missing keep the JAX
semantics."""

import importlib

import pytest
import torch

from musicstyletransfer_torch.models import StyleVAE
from musicstyletransfer_torch.models.config import (DecoderConfig, EncoderConfig, ModelConfig,
                                                    TransformerConfig)
from musicstyletransfer_torch.training import checkpoint as ckpt

PACKAGES = ("training", "ops", "models", "parallel")

# JAX names with no meaning in torch, by the module that defines them, each
# with its reason (ROADMAP queue 3, "Differences by design").
NO_TORCH_MEANING = {
    "training": {
        "shard_train_state": "places a JAX TrainState's arrays on a mesh's shardings; the "
                             "port's Trainer(mesh=) shards the model (parallel.shard_model) "
                             "and its optimizer's flat buffers",
    },
    "ops": {
        "should_interpret": "picks Pallas interpret mode on the CPU; a port wrapper takes its "
                            "plain version from the tensor's device",
    },
    "parallel": {
        "batch_sharding": "a jax.sharding.NamedSharding of the batch; the port's ranks take "
                          "their rows with shard_batch",
        "param_shardings": "NamedShardings of a parameter tree; the port slices with "
                           "shard_params / shard_model",
        "replicated": "the replicated NamedSharding; a torch tensor is whole on its rank",
    },
    "models": {},
    "parallel.mesh": {
        "unchecked_shard_map": "shard_map without JAX's replication checks; the port's ranks "
                               "are processes that call collectives themselves",
    },
    "utils": {
        "configure_jax_cache": "JAX's persistent compilation cache; the port's kernels are "
                               "built once into build/kernels/",
        "respect_platforms_env": "honours JAX_PLATFORMS against a plugin's override; the port "
                                 "picks its device with --cpu / resolve_device",
    },
}


def test_no_torch_meaning_names_are_jax_only():
    for module, names in NO_TORCH_MEANING.items():
        jax_mod = importlib.import_module(f"musicstyletransfer_tpu.{module}")
        port = importlib.import_module(f"musicstyletransfer_torch.{module}")
        for name in names:
            assert hasattr(jax_mod, name), (module, name)
            assert not hasattr(port, name), (module, name)


@pytest.mark.parametrize("package", PACKAGES)
def test_every_jax_name_has_a_counterpart(package):
    jax_pkg = importlib.import_module(f"musicstyletransfer_tpu.{package}")
    port = importlib.import_module(f"musicstyletransfer_torch.{package}")
    skip = NO_TORCH_MEANING[package]
    assert set(skip) <= set(jax_pkg.__all__), sorted(set(skip) - set(jax_pkg.__all__))
    missing = [n for n in jax_pkg.__all__ if n not in skip and not hasattr(port, n)]
    assert not missing, missing
    not_exported = [n for n in jax_pkg.__all__ if n not in skip and n not in port.__all__]
    assert not not_exported, not_exported
    for name in jax_pkg.__all__:
        if name not in skip and name[0].islower() and not name.isupper():
            assert callable(getattr(port, name)), name


def test_names_import_from_the_packages():
    from musicstyletransfer_torch.models import Config, make_model, register_config  # noqa
    from musicstyletransfer_torch.ops import flash_attention, ring_flash_attention  # noqa
    from musicstyletransfer_torch.parallel import (pipeline_apply,  # noqa
                                                   pipeline_apply_lockstep,
                                                   pipeline_transformer_stack,
                                                   stack_stage_params, transformer_stage_fn)
    from musicstyletransfer_torch.training import Trainer, build_optimizer, make_train_step  # noqa


def test_ops_flash_attention_is_module_and_function():
    """``ops.flash_attention`` stays the module (its wrappers are reached
    through it) and is callable as the function of its name."""
    from musicstyletransfer_torch.ops import flash_attention as fa

    q = torch.randn(1, 2, 8, 4, generator=torch.Generator().manual_seed(0))
    lens = torch.tensor([5])
    assert torch.equal(fa(q, q, q, lens, True), fa.flash_attention(q, q, q, lens, True))
    assert callable(fa.flash_forward)
    out = fa.reference_attention(q, q, q, lens, True, 0.5)
    assert float((out - fa.flash_forward_reference(q, q, q, lens, True, 0.5)[0]).abs().max()) \
        < 1e-6


def tiny_model():
    tc = TransformerConfig(model_size=16, num_layers=1, num_heads=2)
    return StyleVAE(ModelConfig(EncoderConfig(transformer_config=tc, latent_dim=4),
                                DecoderConfig(transformer_config=tc, latent_dim=4),
                                dtype="float32"))


def test_checkpoint_helpers_keep_jax_semantics(tmp_path):
    folder = str(tmp_path)
    with pytest.raises(ValueError, match="No checkpoints"):
        ckpt.get_latest_checkpoint_index(folder)
    assert ckpt.try_latest(folder) is None
    assert ckpt.try_latest(str(tmp_path / "absent")) is None
    model = tiny_model()
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    for i in (1, 3):
        ckpt.save_checkpoint(folder, i, {"params": flat * i, "optimizer": {}, "step": i})
    (tmp_path / "params.4.pt.123.tmp").write_bytes(b"an interrupted save")
    assert ckpt.checkpoint_indices(folder) == [1, 3]
    assert ckpt.get_latest_checkpoint_index(folder) == ckpt.try_latest(folder) == 3
    assert torch.equal(ckpt.restore_params(folder, 3), flat * 3)
    named = ckpt.restore_params(folder, 1, model)
    assert list(named) == [n for n, _ in model.named_parameters()]
    for n, p in model.named_parameters():
        assert torch.equal(named[n], p.detach())
    with pytest.raises(ValueError, match="template"):
        ckpt.restore_params(folder, 1, StyleVAE(ModelConfig(dtype="float32")))


def test_config_save_load_and_copy(tmp_path):
    from musicstyletransfer_torch.models import Config, GANConfig, register_config

    cfg = ModelConfig(dtype="float32")
    cfg.save(str(tmp_path / "c.json"))
    assert Config.load(str(tmp_path / "c.json")) == cfg
    assert cfg.copy(dtype="bfloat16").dtype == "bfloat16"
    GANConfig().save(str(tmp_path / "g.json"))
    assert Config.load(str(tmp_path / "g.json")) == GANConfig()
    assert register_config(GANConfig) is GANConfig


def test_train_step_factories(tmp_path):
    """build_optimizer, create_train_state, make_train_step and
    make_eval_step drive one step and one evaluation on the CPU."""
    from musicstyletransfer_torch.training import (LossConfig, OptimizerConfig, build_optimizer,
                                                   create_train_state, make_eval_step,
                                                   make_train_step)

    model = tiny_model()
    opt = build_optimizer(OptimizerConfig("adam", "", 1e-3), model.parameters())
    state = create_train_state(model)
    step = make_train_step(model, opt, LossConfig())
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(3, 293, (4, 6), generator=g)
    tokens[:, 0] = 1
    seq_lens = torch.full((4,), 6)
    classes = torch.tensor([0, 1, 0, 1])
    labels = torch.roll(tokens, -1, 1)
    before = opt.flat.clone()
    assert step(state, tokens, seq_lens, classes, labels, g) is state
    assert int(state.step) == 1 and not torch.equal(before, opt.flat)
    metrics = make_eval_step(model, LossConfig())(tokens, seq_lens, classes, labels, 4)
    assert torch.isfinite(metrics["total_loss"][0])
