"""Class-conditional GAN with the PyTorch port: short adversarial training,
then MIDI generation.

Trains the GAN family (``musicstyletransfer_torch/models/gan.py``, the widths
of ``scripts/train-gan.sh``) on the bundled guitar/bass corpus for a few
epochs, generates MIDI for each class and prints the class-conditional
quality statistics (pitch-class and octave JS against the corpus profiles);
then does the same from the shipped generator
(``models/gan_guitar_bass/torch/``).

    python examples/torch_gan_generation.py [corpus_dir] [out_dir] [epochs] [--cpu]

Defaults: work/data/guitar_bass, /tmp/mst-gan-example, 20 epochs. Runs on
the CUDA card (bfloat16, each group of D/G steps one CUDA-graph replay), and
raises where there is none, unless ``--cpu`` (float32).
"""

import argparse
import os
import sys

# Runnable from a plain checkout (no pip install): the repo root is the
# example's parent directory.
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from musicstyletransfer_torch.convert import load_npz, params_from_jax  # noqa: E402
from musicstyletransfer_torch.data import Loader, load_dataset  # noqa: E402
from musicstyletransfer_torch.inference.quality import class_conditional_stats  # noqa: E402
from musicstyletransfer_torch.models.config import (DiscriminatorConfig,  # noqa: E402
                                                    GANConfig, GeneratorConfig,
                                                    load_gan_config)
from musicstyletransfer_torch.models.gan import make_generator  # noqa: E402
from musicstyletransfer_torch.training.gan_trainer import (GANTrainConfig,  # noqa: E402
                                                           GANTrainer)
from musicstyletransfer_torch.utils import resolve_device  # noqa: E402

SHIPPED = os.path.join(REPO, "models", "gan_guitar_bass", "torch")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("corpus_dir", nargs="?", default=os.path.join(REPO, "work/data/guitar_bass"))
    parser.add_argument("out_dir", nargs="?", default="/tmp/mst-gan-example")
    parser.add_argument("epochs", nargs="?", type=int, default=20)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)
    device = resolve_device(cpu=args.cpu)

    L = 64
    loader = Loader(path=args.corpus_dir, max_sequence_length=L, slices_per_quarter_note=4)
    dataset, _ = load_dataset(loader, 32, 0.0, None)
    config = GANConfig(
        generator_config=GeneratorConfig(
            n_layers=1, hidden_dim=256, emb_dim=256, noise_dim=64,
            num_classes=dataset.num_classes(), output_dim=dataset.num_tokens(), max_seq_len=L),
        discriminator_config=DiscriminatorConfig(
            n_layers=1, hidden_dim=256, emb_dim=256, num_classes=dataset.num_classes(),
            input_dim=dataset.num_tokens()),
        dtype="bfloat16" if device.type == "cuda" else "float32",
    )
    trainer = GANTrainer(config, GANTrainConfig(checkpoint_frequency=0, sampling_frequency=0,
                                                num_samples=8), device=device)
    metrics = trainer.fit(dataset, os.path.join(args.out_dir, "model"), epochs=args.epochs)
    print("final:", {k: round(v, 4) for k, v in metrics.items()})

    paths = trainer.sample_to_midi(os.path.join(args.out_dir, "samples"))
    print(f"wrote {len(paths)} MIDI samples to {args.out_dir}/samples")

    melodies = loader.melodies
    corpus = {i: [m.tokens for m in melodies[name]] for i, name in enumerate(sorted(melodies))}
    stats = class_conditional_stats(trainer.generate_class_rows(), corpus)
    print("quality:", {k: round(v, 4) for k, v in stats.items()})

    # the shipped generator, from its export
    shipped_config, _ = load_gan_config(os.path.join(SHIPPED, "config.json"))
    gen = make_generator(shipped_config)
    gen.load_state_dict(params_from_jax(load_npz(os.path.join(SHIPPED, "params.npz"))))
    gen = gen.to(device)
    paths = trainer.sample_to_midi(os.path.join(args.out_dir, "shipped"), gen)
    print(f"wrote {len(paths)} MIDI samples of the shipped generator to {args.out_dir}/shipped")
    stats = class_conditional_stats(trainer.generate_class_rows(gen), corpus)
    print("shipped quality:", {k: round(v, 4) for k, v in stats.items()})


if __name__ == "__main__":
    main()
