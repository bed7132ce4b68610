"""Training entry point of the PyTorch port:

    python -m musicstyletransfer_torch.cli.main --data work/data/guitar_bass \\
        --model-output models/wide --max-seq-len 512 --batch-size 8 ...

The JAX CLI's flags (``python -m musicstyletransfer_tpu.cli.main``; the
recipes in ``scripts/train-vae*.sh`` pass them unchanged) plus
``--log-every``. It runs on CUDA, and fails when there is no card, unless
``--cpu`` is given. The model is initialised from ``--seed`` and trained
from scratch, or resumed from the newest checkpoint in ``--model-output``;
every checkpoint also writes ``<model-output>/torch/`` for
``musicstyletransfer_torch.cli.sample``.

``--toy`` trains the reference's toy model (D=32, 2 heads, vocabulary 10)
on ``ToyData`` into ``/tmp/music-style-transfer/toy/model``. On CUDA every
group of ``--steps-per-dispatch`` steps is one CUDA-graph replay;
``--prefetch``, ``--grad-accum-steps``, ``--profile-dir`` (a
``torch.profiler`` trace of steps 10-20) and ``--log-param-grad-norms`` do
what they do in the JAX CLI. ``--remat`` recomputes each layer in the
backward. ``--ring-attention`` with ``--tp 1`` (as
``scripts/train-vae-long.sh`` passes it by default) runs on one device as the
JAX package does there: no ring, the flash route at T >= ``flash_min_seq_len``.
``--rng-impl`` is accepted and has no effect (randomness comes from one
``torch.Generator``). ``--decoder-type lstm`` trains the legacy LSTM
decoder, its widths from ``--d-n-layers``, ``--d-rnn-hidden-dim`` and
``--d-dropout`` as in the JAX CLI (``--toy`` ignores it, as the JAX toy
does).

Multi-process training runs one process per card, each with the same flags
and its own ``--dist-process-id``::

    python -m musicstyletransfer_torch.cli.main --dist-coordinator HOST:PORT \
        --dist-num-processes N --dist-process-id I [--tp T] ...

Process I uses ``cuda:(I % device_count)`` and NCCL (gloo with ``--cpu``).
The N processes form a (N / T, T) mesh (``parallel/mesh.py``): data parallel
over N / T, and over T either tensor parallelism (heads and FFN columns) or,
with ``--ring-attention``, the time axis (ring attention). ``--tp`` > 1
needs ``--dist-*``: the JAX CLI's single process would take every local
device, a torch process drives one. ``--dist-num-cpu-devices`` (the JAX
package's virtual CPU devices) has no meaning here and is refused.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..data import Loader, ToyData, load_dataset
from ..inference.sampler import get_sampler
from ..models.config import (DecoderConfig, EncoderConfig, LSTMConfig, ModelConfig,
                             TransformerConfig)
from ..models.vae import StyleVAE, init_params
from ..parallel import ProcessShardedDataset, initialize_distributed, make_mesh
from ..parallel.distributed import data_process_info
from ..training.optimizer import OptimizerConfig
from ..training.trainer import TrainConfig, Trainer
from ..utils import resolve_device
from .flags import add_decoder_block_flags, build_parser


def decoder_block(args) -> dict:
    """The decoder's block fields from ``add_decoder_block_flags`` (none
    where a namespace lacks them: the reference's block)."""
    if not hasattr(args, "d_ffn"):
        return {}
    return dict(
        num_heads=args.d_num_heads or args.e_num_heads, num_kv_heads=args.d_num_kv_heads,
        head_dim=args.d_head_dim,
        layer_types=tuple(t for t in args.d_layer_types.split(",") if t),
        sliding_window=args.d_sliding_window, bias=not args.d_no_bias, norm=args.d_norm,
        norm_scheme=args.d_norm_scheme or args.norm_scheme, ffn=args.d_ffn,
        num_experts=args.d_num_experts, experts_per_token=args.d_experts_per_token,
        expert_width=args.d_expert_width, positions=args.d_positions,
        rope_theta=args.d_rope_theta, yarn_factor=args.d_yarn_factor,
        yarn_original_max_positions=args.d_yarn_original_max_positions,
        yarn_beta_fast=args.d_yarn_beta_fast, yarn_beta_slow=args.d_yarn_beta_slow,
        yarn_attention_factor=args.d_yarn_attention_factor)


def create_model_config(args, dataset) -> ModelConfig:
    """The JAX CLI's ``create_model_config`` (the decoder takes the
    encoder's head count, as there), with the decoder's block from the
    port's own flags (``decoder_block``)."""
    def transformer(size, dropout, layers, **block):
        kw = dict(
            model_size=size, dropout=dropout, num_layers=layers,
            vocab_size=dataset.num_tokens(), num_heads=args.e_num_heads,
            use_flash_attention=args.use_flash_attention,
            attention_core_xla_backward=args.attention_core_xla_backward,
            norm_scheme=args.norm_scheme, remat=args.remat,
            ring_attention=args.ring_attention, sequence_sharding=args.ring_attention)
        kw.update(block)
        return TransformerConfig(**kw)

    return ModelConfig(
        encoder_config=EncoderConfig(
            transformer_config=transformer(args.e_rnn_hidden_dim, args.e_dropout,
                                           args.e_n_layers),
            latent_dim=args.latent_dim, num_classes=dataset.num_classes(),
            input_dim=dataset.num_tokens()),
        decoder_config=DecoderConfig(
            transformer_config=transformer(args.d_rnn_hidden_dim, args.d_dropout,
                                           args.d_n_layers, **decoder_block(args)),
            latent_dim=args.latent_dim, num_classes=dataset.num_classes(),
            output_dim=dataset.num_tokens(), decoder_type=args.decoder_type,
            lstm_config=(LSTMConfig(n_layers=args.d_n_layers,
                                    hidden_dim=args.d_rnn_hidden_dim,
                                    dropout=args.d_dropout)
                         if args.decoder_type == "lstm" else None),
            class_conditioning=args.class_conditioning),
        dtype=args.dtype,
    )


def create_train_config(args) -> TrainConfig:
    return TrainConfig(
        batch_size=args.batch_size,
        sampling_frequency=args.sampling_frequency,
        checkpoint_frequency=args.checkpoint_frequency,
        num_checkpoints_not_improved=args.num_checkpoints_not_improved,
        optimizer=OptimizerConfig(optimizer=args.optimizer,
                                  optimizer_params=args.optimizer_params,
                                  learning_rate=args.learning_rate),
        kl_loss_weight=args.kl_loss,
        kl_anneal_steps=args.kl_anneal_steps,
        free_bits=args.free_bits,
        label_smoothing=args.label_smoothing,
        logdir=args.logdir,
        log_every=args.log_every,
        seed=args.seed,
        keep_checkpoints=args.keep_checkpoints,
        gen_health_rows=args.gen_health_rows,
        steps_per_dispatch=args.steps_per_dispatch,
        prefetch=args.prefetch,
        grad_accum_steps=args.grad_accum_steps,
        log_param_grad_norms=args.log_param_grad_norms,
        profile_dir=args.profile_dir,
    )


TOY_MODEL = "/tmp/music-style-transfer/toy/model"  # the reference's (main.py:59-76)


def create_toy_model_config(data) -> ModelConfig:
    """Reference: main.py:14-38 (create_toy_model_config)."""
    tc = TransformerConfig(model_size=32, dropout=0.0, num_layers=1, num_heads=2,
                           vocab_size=data.num_tokens())
    return ModelConfig(
        encoder_config=EncoderConfig(transformer_config=tc, latent_dim=16,
                                     num_classes=data.num_classes(),
                                     input_dim=data.num_tokens()),
        decoder_config=DecoderConfig(transformer_config=tc, latent_dim=16,
                                     num_classes=data.num_classes(),
                                     output_dim=data.num_tokens()),
        dtype="float32",
    )


def create_toy_train_config(logdir: str = "/tmp/out") -> TrainConfig:
    """Reference: main.py:41-56."""
    return TrainConfig(
        batch_size=1, sampling_frequency=500, checkpoint_frequency=1000,
        num_checkpoints_not_improved=-1, kl_loss_weight=1.0, logdir=logdir,
        optimizer=OptimizerConfig(learning_rate=1e-3, optimizer="adam",
                                  optimizer_params="clip_gradient:1.0"),
    )


def main_toy(args, epochs: int = 20000, model_folder: str = TOY_MODEL,
             config: Optional[ModelConfig] = None) -> None:
    """Reference: main.py:59-76 (main_toy): the toy model (or ``config``)
    trained on ``ToyData`` (validated on it too) into ``model_folder``, whose
    ``torch/`` export ``cli.sample --toy`` reads."""
    dataset = ToyData()
    device = resolve_device(gpu=args.gpu, cpu=args.cpu)
    os.makedirs(model_folder, exist_ok=True)
    config = config if config is not None else create_toy_model_config(dataset)
    model = init_params(StyleVAE(config), args.seed).to(device)
    trainer = Trainer(create_toy_train_config(os.path.join(model_folder, "log")), model)
    trainer.fit(dataset=dataset, validation_dataset=dataset, model_folder=model_folder,
                epochs=epochs)


def _refuse_unported(args) -> None:
    if args.dist_num_cpu_devices is not None:
        raise SystemExit("train: --dist-num-cpu-devices is not ported to PyTorch: a torch "
                         "process drives one device, so a CPU world is --cpu processes, one a "
                         "rank (gloo)")
    if args.tp > 1 and args.dist_coordinator is None:
        raise SystemExit(
            f"train: --tp {args.tp} needs one process per card: launch {args.tp} (or a "
            "multiple of it) cli.main processes with --dist-coordinator HOST:PORT "
            "--dist-num-processes N --dist-process-id I")


def setup_distributed(args, device: torch.device):
    """Join the world of ``--dist-*`` and lay out its mesh: (device, mesh),
    the device cuda:(process id % cards) on CUDA."""
    if device.type == "cuda":
        device = torch.device("cuda", args.dist_process_id % torch.cuda.device_count())
    else:  # the world's processes share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.dist_num_processes))
    initialize_distributed(args.dist_coordinator, args.dist_num_processes,
                           args.dist_process_id, device)
    mesh = make_mesh(args.tp, device)
    print(f"Process {args.dist_process_id + 1}/{args.dist_num_processes}: {mesh}")
    return device, mesh


def main(argv=None) -> None:
    parser = build_parser()
    parser.add_argument("--log-every", type=int, default=50,
                        help="log (print and scalars.jsonl) every N steps")
    add_decoder_block_flags(parser)
    args, _ = parser.parse_known_args(argv)
    _refuse_unported(args)
    if args.toy:
        main_toy(args, model_folder=TOY_MODEL)
        return
    device = resolve_device(gpu=args.gpu, cpu=args.cpu)
    mesh = None
    if args.dist_coordinator is not None:
        device, mesh = setup_distributed(args, device)
    try:
        _train(args, device, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _train(args, device: torch.device, mesh) -> None:
    def loader(path):
        return Loader(path=path, max_sequence_length=args.max_seq_len,
                      slices_per_quarter_note=args.slices_per_quarter_note)

    val_loader = loader(args.validation_data) if args.validation_data is not None else None
    train_dataset, valid_dataset = load_dataset(loader(args.data), args.batch_size,
                                                args.validation_split, val_loader)
    if mesh is not None:
        # every process reads the same batches and keeps its data rank's rows;
        # validation stays whole (Trainer._eval_pass slices it)
        train_dataset = ProcessShardedDataset(train_dataset, data_process_info(mesh))
    os.makedirs(args.model_output, exist_ok=True)
    if args.out_samples:
        os.makedirs(args.out_samples, exist_ok=True)

    config = create_model_config(args, train_dataset)
    print(f"Using configuration:\n{config}")
    model = init_params(StyleVAE(config), args.seed).to(device)
    print(f"Model parameters: {sum(p.numel() for p in model.parameters()):,}")

    # The reference hardcodes 'sampling' here (main.py:156) even though it
    # parses --sampling-type; the flag is honoured, as in the JAX CLI.
    sampler = (get_sampler(args.sampling_type, None, None, args, device, model=model)
               if mesh is None else None)  # no in-training sampling under a mesh (as JAX)
    trainer = Trainer(create_train_config(args), model, sampler=sampler, mesh=mesh)
    trainer.fit(dataset=train_dataset, validation_dataset=valid_dataset,
                model_folder=args.model_output, epochs=args.epochs)
    print("Training finished.")


if __name__ == "__main__":
    main()
