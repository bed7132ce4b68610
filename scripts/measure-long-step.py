#!/usr/bin/env python3
"""Time the long training step and the flash kernels (K4/K5) of one tree of
this repository on one CUDA card, in float32 or bf16.

    python3 scripts/measure-long-step.py [TREE] [LABEL] [--dtype float32]
        [--recipe train-vae.sh] [--flags "--max-seq-len 2046 ..."]

TREE (default: the tree holding this script) is a checkout of the repository,
for example an older commit unpacked with ``git archive`` into a directory
that .gitignore lists; its own ``chip_smoke.py`` and package are imported,
so two trees are compared on one card by running this script once for each,
in turns (old, new, new, old). Prints the step of scripts/train-vae-long.sh
(or of ``--recipe``, with ``--flags`` added: it must come to B=4, L=2046;
B=4, L=2046, the corpus's first batch, seeded weights) eager and as replays
of a CUDA graph of the recipe's steps per dispatch: CUDA-event ms, the
device's busy share and the flash kernels' share of the kernel time
(``chip_smoke.measure_training``); then K4 and K5 per launch at both long
shapes at the recipe's head dimensions (its encoder's and decoder's widths
over --e-num-heads) on the same batch's key lengths, the card held back while
the host enqueues. Needs a card.
"""

import argparse
import os
import sys


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("tree", nargs="?", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("label", nargs="?")
    parser.add_argument("--dtype", choices=["bfloat16", "float32"], default="float32")
    parser.add_argument("--recipe", default="train-vae-long.sh")
    parser.add_argument("--flags", default="", help="flags added to the recipe's")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    label = args.label or os.path.basename(tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("measure-long-step: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from musicstyletransfer_torch.cli.flags import build_parser
    from musicstyletransfer_torch.data import Loader, MelodyDataset
    from musicstyletransfer_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    extra = tuple(args.flags.split()) + ("--dtype", args.dtype)
    recipe = cs.recipe_argv(args.recipe, "-", "-", "-", required=("--max-seq-len",)) + list(extra)
    flags = build_parser().parse_known_args(recipe)[0]
    if (flags.max_seq_len, flags.batch_size) != (cs.LONG_L, cs.LONG_B):
        print(f"measure-long-step: {args.recipe} {args.flags} runs B={flags.batch_size}, "
              f"L={flags.max_seq_len}, not B={cs.LONG_B}, L={cs.LONG_L}", file=sys.stderr)
        return 2
    hds = (flags.e_rnn_hidden_dim // flags.e_num_heads, flags.d_rnn_hidden_dim // flags.e_num_heads)
    name = f"{args.recipe} {args.flags}".strip()
    cs.log(f"[{label}] {tree}, {name}, {args.dtype}")
    corpus = os.path.join(tree, "work", "data", "guitar_bass")
    batch = next(iter(MelodyDataset(cs.LONG_B, cs.LONG_L, Loader(corpus, cs.LONG_L).melodies)))
    step = cs.measure_training(batch, f"[{label}] {name} {args.dtype}", args.recipe,
                               {"K4": ("flash_fwd_kernel",), "K5": ("flash_bwd_",),
                                "split": ("split_bf16x3",)}, flags.steps_per_dispatch,
                               extra=extra)
    for mode in ("eager", "graphed"):
        cs.log(f"[{label}] {name} step {args.dtype}, {mode}: {step[mode]['ms']:.3f} ms (CUDA "
               f"events), {step[mode]['kernel_ms']:.3f} ms of kernels, busy "
               f"{step[mode]['busy']:.3f}, kernel shares {step[mode]['shares']}")
    seq_lens = torch.as_tensor(batch.seq_lens).long()
    for (name, T, _, causal), hd in zip(cs.FLASH_SHAPES, hds):
        lens = (seq_lens if name == "encoder" else seq_lens + 1).to(torch.int32).cuda()
        q, k, v, dout, _ = cs.flash_inputs(cs.LONG_B, T, hd, dtype, seed=1)
        scale = hd ** -0.5
        fwd = lambda: fa.flash_forward(q, k, v, lens, causal, scale)  # noqa: E731
        o, lse = fwd()
        bwd = lambda: fa.flash_backward(q, k, v, lens, lse, o, dout, causal, scale)  # noqa: E731
        k4, k5 = cs.time_cuda(fwd, 20, queued=True), cs.time_cuda(bwd, 20, queued=True)
        cs.log(f"[{label}] {name} T={T} hd={hd} causal={causal} {args.dtype} "
               f"({fa.kernel_route(dtype, hd)} kernels): K4 {k4:.4f} ms, K5 {k5:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
