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

Refused until ported (ROADMAP queue 1): ``--toy``, ``--decoder-type lstm``,
``--tp`` > 1, multi-process (``--dist-*``), ``--grad-accum-steps`` > 1,
``--profile-dir``, ``--log-param-grad-norms``, ``--remat``,
``--ring-attention`` and ``--sampling-type beam-search``. ``--prefetch`` and ``--rng-impl`` are accepted and
have no effect (batches are laid out on the host and copied; randomness
comes from one ``torch.Generator``).
"""

from __future__ import annotations

import os

from ..data import Loader, load_dataset
from ..inference.sampler import get_sampler
from ..models.config import DecoderConfig, EncoderConfig, ModelConfig, TransformerConfig
from ..models.vae import StyleVAE, init_params
from ..training.optimizer import OptimizerConfig
from ..training.trainer import TrainConfig, Trainer
from ..utils import resolve_device
from .flags import build_parser


def create_model_config(args, dataset) -> ModelConfig:
    """The JAX CLI's ``create_model_config`` (the decoder takes the
    encoder's head count, as there)."""
    def transformer(size, dropout, layers):
        return TransformerConfig(
            model_size=size, dropout=dropout, num_layers=layers,
            vocab_size=dataset.num_tokens(), num_heads=args.e_num_heads,
            use_flash_attention=args.use_flash_attention,
            attention_core_xla_backward=args.attention_core_xla_backward,
            norm_scheme=args.norm_scheme, remat=args.remat,
            ring_attention=args.ring_attention, sequence_sharding=args.ring_attention)

    return ModelConfig(
        encoder_config=EncoderConfig(
            transformer_config=transformer(args.e_rnn_hidden_dim, args.e_dropout,
                                           args.e_n_layers),
            latent_dim=args.latent_dim, num_classes=dataset.num_classes(),
            input_dim=dataset.num_tokens()),
        decoder_config=DecoderConfig(
            transformer_config=transformer(args.d_rnn_hidden_dim, args.d_dropout,
                                           args.d_n_layers),
            latent_dim=args.latent_dim, num_classes=dataset.num_classes(),
            output_dim=dataset.num_tokens(), decoder_type=args.decoder_type,
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
    )


def _refuse_unported(args) -> None:
    unported = {
        "--toy": args.toy,
        "--tp > 1": args.tp > 1,
        "--dist-coordinator": args.dist_coordinator is not None,
        "--grad-accum-steps > 1": args.grad_accum_steps > 1,
        "--profile-dir": args.profile_dir is not None,
        "--log-param-grad-norms": args.log_param_grad_norms,
    }
    for flag, asked in unported.items():
        if asked:
            raise SystemExit(f"train: {flag} is not ported to PyTorch yet "
                             "(ROADMAP queue 1)")


def main(argv=None) -> None:
    parser = build_parser()
    parser.add_argument("--log-every", type=int, default=50,
                        help="log (print and scalars.jsonl) every N steps")
    args, _ = parser.parse_known_args(argv)
    _refuse_unported(args)
    device = resolve_device(gpu=args.gpu, cpu=args.cpu)

    def loader(path):
        return Loader(path=path, max_sequence_length=args.max_seq_len,
                      slices_per_quarter_note=args.slices_per_quarter_note)

    val_loader = loader(args.validation_data) if args.validation_data is not None else None
    train_dataset, valid_dataset = load_dataset(loader(args.data), args.batch_size,
                                                args.validation_split, val_loader)
    os.makedirs(args.model_output, exist_ok=True)
    if args.out_samples:
        os.makedirs(args.out_samples, exist_ok=True)

    config = create_model_config(args, train_dataset)
    print(f"Using configuration:\n{config}")
    model = init_params(StyleVAE(config), args.seed).to(device)
    print(f"Model parameters: {sum(p.numel() for p in model.parameters()):,}")

    # The reference hardcodes 'sampling' here (main.py:156) even though it
    # parses --sampling-type; the flag is honoured, as in the JAX CLI.
    sampler = get_sampler(args.sampling_type, None, None, args, device, model=model)
    trainer = Trainer(create_train_config(args), model, sampler=sampler)
    trainer.fit(dataset=train_dataset, validation_dataset=valid_dataset,
                model_folder=args.model_output, epochs=args.epochs)
    print("Training finished.")


if __name__ == "__main__":
    main()
