#!/usr/bin/env python3
"""Time the wide training step and the attention core (K2/K3) of one tree
of this repository on one CUDA card.

    python3 scripts/measure-wide-step.py [TREE] [LABEL]

TREE (default: the tree holding this script) is a checkout of the repository,
for example an older commit unpacked with ``git archive`` into a directory
that .gitignore lists; its own ``chip_smoke.py`` and package are imported,
so two trees are compared on one card by running this script once for each,
in turns (old, new, new, old). Prints the step's CUDA-event time, its host
clock, the device's busy share and kernel time a step by name
(``chip_smoke.measure_training``), then K2 and K3 at both wide shapes with
the card held back while the host enqueues, and the wrappers' host time a
call (the least and the median of five rounds of 100 calls). Needs a card.
"""

import math
import os
import sys
import time


def main() -> int:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    label = sys.argv[2] if len(sys.argv) > 2 else os.path.basename(tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("measure-wide-step: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from musicstyletransfer_torch.data import Loader, MelodyDataset
    from musicstyletransfer_torch.ops import attention_core as ac

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(f"[{label}] {tree}")
    corpus = os.path.join(tree, "work", "data", "guitar_bass")
    batch = next(iter(MelodyDataset(8, 512, Loader(corpus, 512).melodies)))
    # Older trees name a kernel by one substring of its symbol.
    kernels = ({"K2": ("core_fwd_kernel",), "K3": ("core_bwd_",)} if hasattr(cs, "CORE_SHORT")
               else {"K2": "core_fwd_kernel", "K3": "core_bwd_"})
    step = cs.measure_training(batch, f"[{label}] wide", "train-vae-wide.sh", kernels)
    cs.log(f"[{label}] wide step {step['ms']:.3f} ms (CUDA events), {step['host_ms']:.3f} ms host "
           f"clock, busy {step['busy']:.3f}, kernel shares {step['shares']}")
    seq_lens = torch.as_tensor(batch.seq_lens).long()
    for name, T, hd, causal in cs.CORE_SHAPES:
        lens = (seq_lens if name == "encoder" else seq_lens + 1).to(torch.int32).cuda()
        qkv, _, dout = cs.core_inputs(T, hd, torch.bfloat16, seed=1)
        scale = 1.0 / math.sqrt(hd)
        fwd = lambda: ac.core_forward(qkv, lens, cs.CORE_H, causal, scale)  # noqa: E731
        ctx, lse = fwd()
        bwd = lambda: ac.core_backward(qkv, lens, lse, ctx, dout, cs.CORE_H, causal, scale)  # noqa: E731
        k2, k3 = cs.time_cuda(fwd, 40, queued=True), cs.time_cuda(bwd, 40, queued=True)
        host = []  # us of host time a wrapper call, the card left to run behind: 5 rounds
        for fn in (fwd, bwd):
            rounds = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(100):
                    fn()
                rounds.append((time.perf_counter() - t0) / 100 * 1e6)
            torch.cuda.synchronize()
            host.append(f"{min(rounds):.1f} (median {sorted(rounds)[2]:.1f})")
        cs.log(f"[{label}] {name} T={T} hd={hd} causal={causal} bf16: K2 {k2:.4f} ms, K3 {k3:.4f} ms; "
               f"the wrappers' host time {host[0]} / {host[1]} us a call, least of 5 rounds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
