"""Sampling / style-transfer CLI of the PyTorch port:

    python -m musicstyletransfer_torch.cli.sample --model-output models/guitar_bass \\
        --checkpoint -1 --data work/data/guitar_bass --out-samples out/

Same flags as ``python -m musicstyletransfer_tpu.cli.sample``. It runs on
CUDA, and fails when there is no card, unless ``--cpu`` is given. The model
folder needs the ``torch/`` export (``scripts/export-torch-weights.py``, or
a checkpoint written by ``musicstyletransfer_torch.cli.main``). ``--toy``
transfers ``ToyData`` with the toy model that ``cli.main --toy`` trained;
``--sampling-type beam-search`` decodes by beam search (``--beam-size``,
``--length-penalty``).
"""

from __future__ import annotations

from ..data import Loader, MelodyDataset, ToyData
from ..inference.sampler import get_sampler
from ..utils import resolve_device
from .flags import get_config
from .main import TOY_MODEL


def sample_toy(args, model_folder: str = TOY_MODEL) -> None:
    """Reference: sampler.py:261-270: ``ToyData`` through the toy model."""
    device = resolve_device(gpu=args.gpu, cpu=args.cpu)
    sampler = get_sampler("sampling", model_folder, args.checkpoint, args, device)
    sampler.process_dataset(ToyData(), args.out_samples)


def main(argv=None) -> None:
    args = get_config(argv)
    if not args.out_samples:
        raise SystemExit("sample: --out-samples OUTPUT_DIR is required "
                         "(where the transferred .mid files are written)")
    if args.toy:
        sample_toy(args, TOY_MODEL)
        return
    device = resolve_device(gpu=args.gpu, cpu=args.cpu)
    loader = Loader(path=args.data, max_sequence_length=args.max_seq_len,
                    slices_per_quarter_note=args.slices_per_quarter_note)
    dataset = MelodyDataset(args.batch_size, loader.max_sequence_length,
                            loader.melodies)
    sampler = get_sampler(args.sampling_type, args.model_output, args.checkpoint,
                          args, device)
    sampler.process_dataset(dataset, args.out_samples)


if __name__ == "__main__":
    main()
