#!/usr/bin/env python3
"""Time the long training step and the flash kernels (K4/K5) of one tree of
this repository on one CUDA card, in float32 or bf16.

    python3 scripts/measure-long-step.py [TREE] [LABEL] [--dtype float32]

TREE (default: the tree holding this script) is a checkout of the repository,
for example an older commit unpacked with ``git archive`` into a directory
that .gitignore lists; its own ``chip_smoke.py`` and package are imported,
so two trees are compared on one card by running this script once for each,
in turns (old, new, new, old). Prints the step of scripts/train-vae-long.sh
(B=4, L=2046, the corpus's first batch, seeded weights) eager and as replays
of a CUDA graph of one step: CUDA-event ms, the device's busy share and the
flash kernels' share of the kernel time (``chip_smoke.measure_training``);
then K4 and K5 per launch at both long shapes on the same batch's key
lengths, the card held back while the host enqueues. Needs a card.
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
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    label = args.label or os.path.basename(tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("measure-long-step: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from musicstyletransfer_torch.data import Loader, MelodyDataset
    from musicstyletransfer_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    cs.log(f"[{label}] {tree}, {args.dtype}")
    corpus = os.path.join(tree, "work", "data", "guitar_bass")
    batch = next(iter(MelodyDataset(cs.LONG_B, cs.LONG_L, Loader(corpus, cs.LONG_L).melodies)))
    step = cs.measure_training(batch, f"[{label}] long {args.dtype}", "train-vae-long.sh",
                               {"K4": ("flash_fwd_kernel",), "K5": ("flash_bwd_",),
                                "split": ("split_bf16x3",)}, 1, extra=("--dtype", args.dtype))
    for mode in ("eager", "graphed"):
        cs.log(f"[{label}] long step {args.dtype}, {mode}: {step[mode]['ms']:.3f} ms (CUDA "
               f"events), {step[mode]['kernel_ms']:.3f} ms of kernels, busy "
               f"{step[mode]['busy']:.3f}, kernel shares {step[mode]['shares']}")
    seq_lens = torch.as_tensor(batch.seq_lens).long()
    for name, T, hd, causal in cs.FLASH_SHAPES:
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
