"""GAN training entry point of the PyTorch port:

    python -m musicstyletransfer_torch.cli.gan --data work/data/guitar_bass \\
        --model-output models/gan --batch-size 32 --max-seq-len 64 ...

The JAX CLI's parser (``musicstyletransfer_tpu/cli/gan.py:30-98``: every
flag and default, ``parse_known_args``; ``--d-*`` means the discriminator
here, ``scripts/train-gan.sh`` passes them unchanged). It runs on CUDA, and
fails when there is no card, unless ``--cpu`` is given; ``--gpu`` is
accepted. ``--toy`` trains on ``ToyData`` (L=4, 200 epochs) into
``/tmp/music-style-transfer/toy/torch-gan``. ``--generate N`` trains nothing: it
writes N samples a class (``gan-out-{i}.class-{c}.mid``) to
``--out-samples`` from checkpoint ``--checkpoint`` (-1 the latest) of the
port's own ``generator/params.N.pt``, or, in a folder without them, from the
export ``<model>/torch/`` (``scripts/export-torch-weights.py``); with an
existing ``--data`` folder it also prints one JSON line of
``inference.quality.class_conditional_stats`` against that corpus.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from ..convert import load_npz, params_from_jax
from ..data import Loader, ToyData, load_dataset
from ..inference.sampler import load_flat_params
from ..models.config import DiscriminatorConfig, GANConfig, GeneratorConfig, load_gan_config
from ..models.gan import make_discriminator, make_generator
from ..training import checkpoint as ckpt
from ..training.gan_trainer import GANTrainConfig, GANTrainer
from ..utils import resolve_device

TOY_GAN = "/tmp/music-style-transfer/toy/torch-gan"  # the JAX CLI's toy/gan holds Orbax checkpoints


def build_gan_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()

    net = parser.add_argument_group("Network")
    net.add_argument("--g-n-layers", type=int, default=1)
    net.add_argument("--g-rnn-hidden-dim", type=int, default=256)
    net.add_argument("--g-emb-hidden-dim", type=int, default=256)
    net.add_argument("--noise-dim", type=int, default=64)
    net.add_argument("--d-n-layers", type=int, default=1)
    net.add_argument("--d-rnn-hidden-dim", type=int, default=256)
    net.add_argument("--d-emb-hidden-dim", type=int, default=256)

    data = parser.add_argument_group("Data")
    data.add_argument("--batch-size", type=int, default=32)
    data.add_argument("--max-seq-len", type=int, default=64)
    data.add_argument("--slices-per-quarter-note", type=float, default=4)
    data.add_argument("--data", type=str, default="data")
    data.add_argument("--validation-split", type=float, default=0.0)

    train = parser.add_argument_group("Training")
    train.add_argument("--epochs", type=int, default=10000)
    train.add_argument("--discriminator-update-steps", type=int, default=5)
    train.add_argument("--g-learning-rate", type=float, default=5e-5)
    train.add_argument("--d-learning-rate", type=float, default=5e-5)
    train.add_argument("--label-smoothing", type=float, default=0.0)
    train.add_argument("--negative-label-downscaling", action="store_true")
    train.add_argument("--r1-gamma", type=float, default=0.1,
                       help="R1 gradient-penalty weight on real inputs (default 0.1); "
                            "--parity-gan or 0 turns it off")
    train.add_argument("--parity-gan", action="store_true",
                       help="the bare reconstructed train.sh surface (R1 penalty off)")

    misc = parser.add_argument_group("Misc")
    misc.add_argument("--checkpoint-frequency", type=int, default=5000)
    misc.add_argument("--sampling-frequency", type=int, default=1000)
    misc.add_argument("--out-samples", "-o", type=str, default=None)
    misc.add_argument("--model-output", "-m", type=str, default="models/gan")
    misc.add_argument("--gpu", action="store_true", help="run on CUDA (the default)")
    misc.add_argument("--toy", action="store_true")
    misc.add_argument("--verbose", action="store_true")
    misc.add_argument("--generate", type=int, default=0, metavar="N",
                      help="no training: load a checkpoint from --model-output and write "
                           "N samples per class to --out-samples")
    misc.add_argument("--checkpoint", "-c", type=int, default=-1,
                      help="checkpoint index for --generate (-1 = latest)")

    tpu = parser.add_argument_group("TPU")
    tpu.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    tpu.add_argument("--seed", type=int, default=0)
    tpu.add_argument("--cpu", action="store_true", help="run on the CPU")
    tpu.add_argument("--temperature", type=float, default=1.0)
    tpu.add_argument("--num-samples", type=int, default=8,
                     help="generated MIDIs per class at each sampling tick")
    tpu.add_argument("--logdir", type=str, default=None,
                     help="where <logdir>/scalars.jsonl gets the GAN scalars")
    return parser


def get_gan_config(argv=None) -> argparse.Namespace:
    config, _unparsed = build_gan_parser().parse_known_args(argv)
    return config


def create_gan_config(args, num_classes: int, num_tokens: int, max_seq_len: int) -> GANConfig:
    return GANConfig(
        generator_config=GeneratorConfig(
            n_layers=args.g_n_layers, hidden_dim=args.g_rnn_hidden_dim,
            emb_dim=args.g_emb_hidden_dim, noise_dim=args.noise_dim,
            num_classes=num_classes, output_dim=num_tokens, max_seq_len=max_seq_len),
        discriminator_config=DiscriminatorConfig(
            n_layers=args.d_n_layers, hidden_dim=args.d_rnn_hidden_dim,
            emb_dim=args.d_emb_hidden_dim, num_classes=num_classes, input_dim=num_tokens),
        dtype=args.dtype,
    )


def create_gan_train_config(args) -> GANTrainConfig:
    return GANTrainConfig(
        discriminator_update_steps=args.discriminator_update_steps,
        g_learning_rate=args.g_learning_rate,
        d_learning_rate=args.d_learning_rate,
        label_smoothing=args.label_smoothing,
        negative_label_downweighting=args.negative_label_downscaling,
        r1_gamma=0.0 if args.parity_gan else args.r1_gamma,
        checkpoint_frequency=args.checkpoint_frequency,
        sampling_frequency=args.sampling_frequency,
        num_samples=args.num_samples,
        temperature=args.temperature,
        logdir=args.logdir,
        seed=args.seed,
    )


def main_toy(args, epochs: int = 200, model_folder: str = TOY_GAN) -> None:
    dataset = ToyData()
    device = resolve_device(gpu=args.gpu, cpu=args.cpu)
    config = create_gan_config(args, dataset.num_classes(), dataset.num_tokens(), max_seq_len=4)
    trainer = GANTrainer(config, create_gan_train_config(args), out_samples=args.out_samples,
                         device=device)
    trainer.fit(dataset, model_folder, epochs=epochs)


def load_generator(model_folder: str, checkpoint: int, device: torch.device):
    """(GANConfig, generator in eval mode on ``device``, checkpoint index):
    the port's own ``generator/params.N.pt`` where the folder holds them
    (-1 the latest), else the export ``<model>/torch/params.npz``."""
    export = os.path.join(model_folder, ckpt.EXPORT_DIR)
    config, exported = load_gan_config(os.path.join(export, "config.json"))
    gen = make_generator(config)
    gen_folder = os.path.join(model_folder, "generator")
    indices = ckpt.checkpoint_indices(gen_folder)
    if indices:
        index = indices[-1] if checkpoint == -1 else checkpoint
        if index not in indices:
            raise SystemExit(f"{gen_folder} holds checkpoints {indices}, not {checkpoint}")
        load_flat_params(gen, ckpt.restore_checkpoint(gen_folder, index)["params"])
    else:
        if checkpoint not in (-1, exported):
            raise SystemExit(f"{export} holds checkpoint {exported}, not {checkpoint}")
        index = exported
        gen.load_state_dict(params_from_jax(load_npz(os.path.join(export, "params.npz"))))
    return config, gen.to(device).eval(), index


def generate_only(args, device: torch.device) -> None:
    """Write samples from a checkpoint, no training."""
    config, gen, idx = load_generator(args.model_output, args.checkpoint, device)
    tc = dataclasses.replace(create_gan_train_config(args), num_samples=args.generate)
    trainer = GANTrainer(config, tc, device=device)
    out = args.out_samples or "gan-samples"
    paths = trainer.sample_to_midi(out, gen)
    print(f"wrote {len(paths)} samples from checkpoint {idx} to {out}")

    if args.data and os.path.isdir(args.data):
        # class-conditional quality against the corpus: own-class JS below
        # other-class JS means the conditioning works
        from ..inference.quality import class_conditional_stats

        melodies = Loader(path=args.data, max_sequence_length=args.max_seq_len,
                          slices_per_quarter_note=args.slices_per_quarter_note).read_melodies()
        corpus = {i: [m.tokens for m in melodies[name]]
                  for i, name in enumerate(sorted(melodies))}
        print(json.dumps(class_conditional_stats(trainer.generate_class_rows(gen), corpus)))


def main(argv=None) -> None:
    args = get_gan_config(argv)
    if args.toy:
        main_toy(args)
        return
    device = resolve_device(gpu=args.gpu, cpu=args.cpu)
    if args.generate > 0:
        generate_only(args, device)
        return

    loader = Loader(path=args.data, max_sequence_length=args.max_seq_len,
                    slices_per_quarter_note=args.slices_per_quarter_note)
    train_dataset, _ = load_dataset(loader, args.batch_size, args.validation_split, None)
    os.makedirs(args.model_output, exist_ok=True)
    if args.out_samples:
        os.makedirs(args.out_samples, exist_ok=True)
    config = create_gan_config(args, train_dataset.num_classes(), train_dataset.num_tokens(),
                               args.max_seq_len)
    print(f"Using GAN configuration:\n{config}")
    n_params = sum(p.numel() for m in (make_generator(config), make_discriminator(config))
                   for p in m.parameters())
    print(f"GAN parameters: {n_params:,}")
    trainer = GANTrainer(config, create_gan_train_config(args), out_samples=args.out_samples,
                         device=device)
    trainer.fit(train_dataset, args.model_output, epochs=args.epochs)
    print("GAN training finished.")


if __name__ == "__main__":
    main()
