#!/usr/bin/env python3
"""Peak device memory of one training step of the long recipe
(scripts/train-vae-long.sh: B=4, L=2046, encoder 4 x 512 with FF 2048,
decoder 2 x 256, dropout 0.1, bf16) with and without ``--remat``, on one
CUDA card.

    python3 scripts/remat-memory.py

Three ways, each from the same seeded state and batch, one eager
``step_body`` after a warm-up step: without remat; remat as the package
runs it (each layer's dropout masks drawn before the layer and kept until
the recompute, ``transformer._remat_layer``); and remat that redraws the
masks in the recompute from a copy of the generator state the layer
started from (the package's way before its steps ran under CUDA graphs,
whose capture forbids ``get_state``/``set_state``; copied here only to be
measured). Then the first two as a CUDA graph of one step
(``GraphedSteps``: warm-ups, capture and one replay). Prints, for each, the
peak allocated bytes above what was allocated before the step
(``torch.cuda.max_memory_allocated``), the bytes the graph's pool keeps
reserved, ms a step (CUDA events, the mean of 5 steps), and the bytes of
the dropout masks a remat step draws ([B, T, D] twice and [B, T, FF] a
layer, as ``_remat_layer`` draws them).
"""

import gc
import os
import sys

import torch
from torch.utils.checkpoint import checkpoint

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke as cs  # noqa: E402
from musicstyletransfer_torch.data import Loader, MelodyDataset  # noqa: E402
from musicstyletransfer_torch.models import transformer  # noqa: E402
from musicstyletransfer_torch.training.graph import GraphedSteps  # noqa: E402
from musicstyletransfer_torch.training.train_step import (  # noqa: E402
    TrainState, batch_tensors, metric_names, step_body)

MIB = 2 ** 20


def redrawn_remat_layer(layer, x, key_mask, generator):
    """Remat that replays the generator: the forward and the recompute each
    draw the masks from a fresh generator set to the state ``generator``
    had before the layer (eager only)."""
    start, end = generator.get_state(), []

    def run(x_, mask_):
        g = torch.Generator(device=generator.device)
        g.set_state(start)
        y = layer(x_, mask_, g)
        end.append(g.get_state())
        return y

    y = checkpoint(run, x, key_mask, use_reentrant=False, preserve_rng_state=False)
    generator.set_state(end[0])
    return y


def measure(label, extra, batch, graphed, remat_layer=transformer._remat_layer):
    saved, drawn = transformer._remat_layer, {}

    def counted(layer, x, key_mask, generator):  # the masks' bytes, as _remat_layer draws them
        B, T, D = x.shape
        drawn[id(layer)] = B * T * (2 * D + layer.ff.ff1.out_features)
        return remat_layer(layer, x, key_mask, generator)

    transformer._remat_layer = counted
    try:
        args, model, opt, loss_cfg = cs.recipe_setup("train-vae-long.sh", extra)
        state = TrainState(metric_names(model), "cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        tensors = batch_tensors(batch, "cuda")
        graphs = None
        if graphed:
            graphs = GraphedSteps(model, opt, loss_cfg, state, gen, 1)
            step = lambda: graphs.run([tensors])  # noqa: E731
        else:
            step = lambda: step_body(model, opt, loss_cfg, state, *tensors,  # noqa: E731
                                     generator=gen)
            step()  # warm-up
        torch.cuda.synchronize()
        base, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        drawn.clear()
        step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        kept = torch.cuda.memory_reserved() - reserved
        ms = cs.time_cuda(step, 5)
        cs.log(f"{label} (B={args.batch_size}, L={args.max_seq_len}, {args.dtype}): peak "
               f"{peak / MIB:.1f} MiB above the {base / MIB:.1f} MiB held before the step "
               f"({'capture and first replay' if graphed else 'one eager step'}); reserved "
               f"grew {kept / MIB:.1f} MiB; {ms:.3f} ms a step; {len(drawn)} layers under "
               f"remat, whose dropout masks (bool) come to {sum(drawn.values()) / MIB:.1f} MiB "
               "a step")
    finally:
        transformer._remat_layer = saved
    del model, opt, state, gen, step, graphs
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("remat-memory: needs a CUDA card", file=sys.stderr)
        return 1
    card = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
    cs.log(f"card: {card.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    corpus = os.path.join(cs.REPO, "work", "data", "guitar_bass")
    batch = next(iter(MelodyDataset(cs.LONG_B, cs.LONG_L, Loader(corpus, cs.LONG_L).melodies)))
    measure("no remat, eager", (), batch, False)
    measure("remat (masks drawn ahead), eager", ("--remat",), batch, False)
    measure("remat (generator replayed), eager", ("--remat",), batch, False,
            redrawn_remat_layer)
    measure("no remat, graph of 1 step", (), batch, True)
    measure("remat (masks drawn ahead), graph of 1 step", ("--remat",), batch, True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
