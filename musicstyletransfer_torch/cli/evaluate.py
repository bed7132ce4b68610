"""Offline evaluation CLI of the PyTorch port: metrics of a trained
checkpoint over a corpus.

    python -m musicstyletransfer_torch.cli.evaluate \\
        --model-output models/run1 --checkpoint -1 \\
        --data /path/to/corpus [--batch-size 32] [--max-seq-len 64] [--cpu]

The JAX package's ``cli.evaluate`` (``musicstyletransfer_tpu/cli/
evaluate.py:22-118``): prints ONE JSON line with PAD-ignoring perplexity,
accuracy and top-5, masked CE, KL and total loss, through the port's
``eval_step`` (wrap-padded rows masked out, so the numbers do not depend on
the batch size). ``--transfer-stats`` adds ``inference.quality.
transfer_stats`` on a seeded, shuffled pass of the corpus. It runs on CUDA,
and fails when there is no card, unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json

from ..utils import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-output", "-m", required=True)
    p.add_argument("--checkpoint", "-c", type=int, default=-1)
    p.add_argument("--data", required=True)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--max-seq-len", type=int, default=64)
    p.add_argument("--kl-loss", type=float, default=1.0)
    p.add_argument("--label-smoothing", type=float, default=0.0,
                   help="match the training run's value so losses are "
                        "comparable with its validation logs")
    p.add_argument("--normalize", choices=["valid", "length"], default="valid",
                   help="per-sample CE normalization (match the training run)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--gpu", action="store_true", help="run on CUDA (the default)")
    p.add_argument("--transfer-stats", action="store_true",
                   help="also run all-classes style transfer on a few "
                        "batches and report output-quality statistics "
                        "(EOS termination rate, lengths, pitch-class JS "
                        "divergence to target vs source distribution)")
    p.add_argument("--stats-batches", type=int, default=4)
    return p


def evaluate(model, dataset, kl_weight: float = 1.0, label_smoothing: float = 0.0,
             normalize: str = "valid") -> dict:
    """Aggregate eval metrics of ``model`` (on its device) over a Dataset
    (library entry point). Pass the TRAINING run's loss settings for numbers
    comparable with its validation logs."""
    from ..training.metrics import MetricAccumulator
    from ..training.train_step import LossConfig, batch_tensors, eval_step

    loss_config = LossConfig(kl_weight=kl_weight, label_smoothing=label_smoothing,
                             normalize=normalize)
    acc = MetricAccumulator()
    for batch in dataset:
        acc.update(eval_step(model, loss_config, *batch_tensors(batch, model.device),
                             batch.num_valid))
    return acc.get()


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(gpu=args.gpu, cpu=args.cpu)

    from ..data import Loader, MelodyDataset
    from ..inference.sampler import load_inference_model

    model = load_inference_model(args.model_output, args.checkpoint, device)
    loader = Loader(args.data, args.max_seq_len)
    dataset = MelodyDataset(args.batch_size, args.max_seq_len, loader.melodies, shuffle=False)
    vals = evaluate(model, dataset, kl_weight=args.kl_loss,
                    label_smoothing=args.label_smoothing, normalize=args.normalize)
    if args.transfer_stats:
        from ..inference.quality import transfer_stats

        # A seeded, shuffled pass for the statistics: their content
        # preservation null rotates sources within a batch, and unshuffled
        # batches are consecutive chunks of one file, which deflates the
        # null. The metric pass above stays in corpus order.
        stats_dataset = MelodyDataset(args.batch_size, args.max_seq_len, loader.melodies,
                                      shuffle=True, seed=0)
        vals.update(transfer_stats(model, stats_dataset, dataset.num_classes(),
                                   max_batches=args.stats_batches))
    print(json.dumps({k: round(v, 6) for k, v in sorted(vals.items())}))


if __name__ == "__main__":
    main()
