#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. Requires CUDA; prints the card's name and power limit (nvidia-smi).
2. Builds the kernels of musicstyletransfer_torch/ops/csrc with nvcc, one
   process per source, all at once: K1 (fused_decode.cu), K2/K3 and K4/K5 in
   bfloat16 at head dimension 32 or 64 on the tensor cores
   (flash_attention_tc.cu), K2/K3 in float32 and at the other head
   dimensions (attention_core.cu), K4/K5 there (flash_attention.cu), both on
   the CUDA cores.
3. Holds K1 against its plain PyTorch version on the card, at the canonical
   decoder shape (D=128, H=8, V=293, B=64, T=130) with seeded weights, in
   float32 and bfloat16: forced-mode logits, greedy tokens and scores, the
   top-k/top-p support of sampled tokens, sample-mode statistics over 256
   rows, and a pre-LN + per-step-conditioned two-layer decoder; then at the
   wide decoder (D=512, 2 layers, 16 heads, pre-LN) over T=1026 positions
   and at the long decoder (D=256, 2 layers, 8 heads, post-LN, per_step)
   over T=4094, each on 8 and on 16 rows (the training paths'
   generation-health probe and cli.sample decode 16), checked and timed
   beside its bound. K1 decodes rows in groups on thread-block clusters;
   every line names the plan (rows a group, blocks a cluster, weights
   resident or streamed) it checked and ran. Also at two decoders whose
   widths K1 pads or whose vocabulary outgrows its registers (D=100, H=4,
   FF=400, V=293; D=128, H=8, FF=512, V=400), float32 and bf16, each timed
   once.
4. Holds K2 and K3 against their plain versions at the wide training shapes
   (B=8, H=16; encoder T=513, hd=64; decoder T=514, hd=32, causal), with
   ragged key lengths (one row 1, one row 0), and at two short lengths that
   no tile divides (T=333, hd=32; T=200, hd=64, causal; key lengths
   [T, T/2, 1, 0]), in float32 (CUDA-core kernels) and bfloat16 (tensor-core
   kernels), and K3 at 1e19 cotangents, where every value must be finite.
5. Holds K4 and K5 against their plain versions at the long training shapes
   (H=8; encoder T=2047, hd=64; decoder T=2048, hd=32, causal; the key
   lengths of the corpus's first L=2046 batch plus a row of 1 and a row of
   0), at T=8192 (causal and not) and at two short lengths that no tile
   divides (T=333, hd=32; T=200, hd=64, causal), in float32 and bfloat16, on
   the model's strided [B, T, H, hd] layout: out, lse, and dq/dk/dv with and
   without an lse cotangent, through flash_attention_with_lse's autograd
   too, and K5 at 1e19 cotangents; bfloat16 goes through the tensor-core
   kernels and float32 through the CUDA-core ones, and a second run of K5
   gives the same bits.
6. CUDA graphs of N training steps (training/graph.py) against 2N eager
   steps from one seeded state, at the canonical (N=8, and N=2 with
   --remat), wide (N=4) and long (N=1) recipes: parameters, optimizer
   state, step count, metric sums and generator bit for bit, and the same
   launch counts (the counters count every replay's launches).
   Serving path: the shipped models/guitar_bass export through
   Sampling.process_dataset on the first two batches of work/data/guitar_bass
   (batch 32, L=64); the MIDI parses back, the decode went through K1 only.
   Serving entry points (serving_path, the shipped model, bf16):
   StyleTransferService (buckets 16,32,64, batch 32) serves 64 corpus
   requests through its threaded loop, one K1 launch a micro-batch and no
   plain loop, every result parsed back; the streaming engine's graphed
   cycles equal its eager cycles bit for bit (sampled, admissions between
   cycles); engine greedy against K1 greedy token for token in float32
   (bf16: the share of identical rows printed); cli.serve --http on
   loopback, plain and --streaming, as processes: concurrent posts, /stats,
   /healthz. Timed: the service's closed-loop requests/s and p50/p99, the
   engine's p50/p99 open loop at half that rate, ms a cycle graphed and
   eager, host ops a cycle, the readout copy.
7. Wide training path: musicstyletransfer_torch.cli.main with
   scripts/train-vae-wide.sh's flags (L=512, batch 8, bf16, pre-LN, the
   attention core; each group of 4 steps one CUDA-graph replay) for two
   epochs with a checkpoint after each; a copy of
   the run resumed from the first checkpoint for one epoch, whose first
   logged step must equal the uninterrupted run's; cli.sample on the
   resumed checkpoint, whose MIDI parses back. Loss and gradient norm stay
   finite, no update is skipped, K3 runs on every attention layer of every
   step, every K2 and K3 launch on the tensor-core kernels, and no plain
   version runs on the card.
8. Long training path: cli.main with scripts/train-vae-long.sh's flags
   (L=2046, batch 4, post-LN, per_step, --ring-attention --tp 1; each step
   one graph replay) for two epochs (24 steps) with a checkpoint after
   each, then cli.sample on the
   checkpoint at max_len 4094, whose MIDI parses back. K5 runs on every
   attention layer of every step, every K4 and K5 launch on the tensor-core
   kernels, K2/K3 never, no plain version on the card; loss and gradient
   norm finite, no update skipped.
   Canonical path: cli.main with scripts/train-vae.sh's flags (B=32,
   L=64, groups of 8 steps: one graph replay each, the epoch's remainder
   a graph of its own) for two epochs; cli.evaluate --transfer-stats on
   the folder it wrote; cli.sample with beam search and with sampling on
   it (two files of the corpus).
9. LSTM-decoder VAE (lstm_path: scripts/train-vae.sh --decoder-type lstm,
   the decoder a 1x128 LSTM): CUDA graphs of 8 steps against eager steps
   over 2 groups, bit for bit; cli.main for one epoch (graph replays);
   cli.sample with sampling and with beam search and cli.evaluate
   --transfer-stats on its folder; the step loop's decode timed at B=64,
   T=130; K1 launched 0 times (the LSTM decodes step by step).
   GAN family (gan_path: scripts/train-gan.sh's widths, bf16, D:G 5:1):
   two groups (10 D, 2 G updates) as CUDA-graph replays against eager
   steps, bit for bit, at r1_gamma 0.1 and 0; cli.gan as a process for two
   epochs (checkpoints, the sampling tick at 50; the MIDI parses back) and
   a second process resuming from its last checkpoint; cli.gan --generate
   16 on that folder and on the shipped models/gan_guitar_bass (one JSON
   line of class_conditional_stats each); the shipped generator's classes
   separate on the card (note-on fraction > 0.1, octave JS own < other)
   and its float32 hard rollout equals the CPU's token for token; updates/s
   by bench.py's protocol (median of 5 interleaved chains), eager and
   graphed, r1_gamma 0 and 0.1, with host ops and kernels an update and
   the device's busy share. No hand kernel runs on either path.
10. Times (CUDA events, beside the card's name and power limit): the serving
   transfer, K1 against its plain loop, p50 MIDI->MIDI latency; K2/K3 at
   both wide shapes and K4/K5 at both long shapes and at T=8192 beside their
   bounds, their plain versions and torch's scaled_dot_product_attention,
   and their wrappers' host time a call; the canonical, wide and long
   training steps, eager and as graph replays: ms a step, target tokens per
   second, and from torch.profiler the kernels' ms a step, the device's busy
   share, kernels and host ops a step and the attention kernels' share;
   the same for the LSTM-decoder VAE's step.
11. Ring attention (ring_path, ops/ring_attention.py at train-vae-long.sh's
   widths: encoder T=2047 padded to the ring, hd=64; decoder T=2048, hd=32,
   causal; B=4, bf16, one row's keys inside the first chunk): n = 2 and 4
   ranks in lock step on the one card through the package's step code,
   forward and re-rotating backward, held against K4/K5 on the whole T (out,
   lse, dq/dk/dv at K4/K5's bf16 tolerances), n x n launches a direction on
   the tensor-core kernels; ms of the ring against the whole-T kernels.
12. Multi-process training (dist_path): cli.main with
   scripts/train-distributed.sh's flags (groups of 8, one epoch) as a world
   of one rank on NCCL (--dist-*) and without --dist-*: the same parameters
   and optimizer state bit for bit; in this process, graphs of 8 and 3 steps
   with the gradient's all-reduce captured against eager steps, bit for
   bit; the graphed step with and without the mesh and the all-reduce's ms.
   multi_gpu_path (2-process NCCL: DP=2, tp=2, --ring-attention --tp 2 at
   L=2046; a 2-process sharded greedy transfer against one process's, token
   for token; 2-process GAN DP in float32 against one process's first
   metric means, 1e-4; the wide encoder stack pipelined over 2 processes
   against one process's sequential stack; python -m
   musicstyletransfer_torch.dryrun over min(cards, 4) processes) runs only
   where torch.cuda.device_count() >= 2, and otherwise prints
   "multi_gpu_path: not run (1 card)".
13. Sharded inference (sharded_path, the shipped model, bf16, a world-1
   NCCL mesh laid out by make_mesh without a device): the sharded
   all-classes transfer of 32 corpus sources x 2 classes at greedy equals
   the unsharded call token for token with one K1 launch a data shard; K1
   greedy on each half of the 64 rows equals the whole batch's launch;
   StyleTransferService(mesh=) and StreamingTransferEngine(mesh=) at greedy
   equal mesh=None on 16 corpus requests; ms of the sharded call against
   the unsharded one and of the rows' all-gather. GAN data parallelism
   (gan_dp, train-gan.sh's model, world-1 NCCL mesh): graphed D/G groups
   with the gradients' all-reduce captured equal eager steps and the
   graphed run without a mesh bit for bit; updates/s with and without the
   mesh. The port's examples (examples/torch_style_transfer.py,
   examples/torch_gan_generation.py for one epoch) as processes: every MIDI
   file they write parses back.
14. Pipeline parallelism (pipeline_path, parallel/pipeline.py and
   transformer_pipeline.py, the stages in lock step on the one card): the
   wide encoder stack (train-vae-wide.sh: 4 x 1024, 16 heads, pre-LN, K2/K3)
   on the L=512 batch as pp=4 and pp=2, 4 microbatches, and the long one
   (train-vae-long.sh: 4 x 512, 8 heads, K4/K5) on the L=2046 batch as
   pp=2, 2 microbatches, in float32 and bf16: output and gradients against
   the sequential stack, launches counted, pipelined and sequential ms.
The corpus is read through the C++ tokenizer (midi/native.py, built into
build/native/ at first use).

Exits non-zero on any failure. The last line of standard output is
{"ok": true, "device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

import contextlib
import glob
import json
import math
import os
import re
import shlex
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

T_START = time.perf_counter()
REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

B, T, L = 64, 130, 64  # decode rows (32 sources x 2 classes), max_len, source length
# Tolerances, kernel vs plain version on the card:
# - float32: the two sum in different orders (f32 rounding, ~1e-6 relative,
#   grown over 130 dependent positions);
# - bfloat16: both round at the same places, but a one-ulp difference in a
#   float32 sum can round to a neighbouring bf16 value (0.4% relative) and
#   travel down the positions; 0.15 is the bound the JAX package's own
#   kernel-vs-XLA bf16 test uses (tests/test_fused_decode.py).
TOL_LOGITS = {torch.float32: 1e-3, torch.bfloat16: 0.15}
TOL_SCORE_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

# The wide recipe's attention shapes: (name, T, head_dim, causal), B=8, H=16;
# and two short lengths that no tile of the tensor-core kernels divides, with
# key lengths [T, T/2, 1, 0].
CORE_SHAPES = (("encoder", 513, 64, False), ("decoder", 514, 32, True))
CORE_SHORT = (("short", 333, 32, False), ("short", 200, 64, True))
CORE_B, CORE_H = 8, 16
# K2/K3 against their plain versions on the card:
# - float32: the same float32 products summed in other orders (the kernel's
#   online softmax rescales as it goes): ~1e-6 on O(1) values;
# - bfloat16: both round q*scale, p and the outputs to bf16 (2^-8 relative),
#   but the kernel rounds p against its running maximum, the plain version
#   against the row's final one, so single probabilities round apart: a
#   few bf16 ulps on the context; lse is float32 in both.
# dqkv is compared relative to its largest magnitude. The tensor-core K3 and
# K5 add rounding points of their own: P (for dv) and dS (for dq, dk) are rounded
# to bf16 before the second products, 2^-9 relative a term, summed over up to
# 2048 terms of mixed sign: well inside the 2e-2 of the largest gradient
# (measured 3e-3 to 8e-3); S is scaled after the product and dk at the end,
# which moves one float32 rounding.
TOL_CTX = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
TOL_LSE = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
TOL_DQKV_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The long recipe's attention shapes: (name, T, head_dim, causal), H=8; and
# the streaming regime's length, where the JAX dispatch takes K4b/K5b/K5c.
FLASH_SHAPES = (("encoder", 2047, 64, False), ("decoder", 2048, 32, True))
FLASH_H, FLASH_LONG_T = 8, 8192
LONG_L, LONG_B = 2046, 4
# Two short lengths that no tile of the tensor-core kernels divides:
# (name, T, head_dim, causal, key_lens).
FLASH_SHORT = (("short", 333, 32, False, [333, 129, 1, 0]),
               ("short", 200, 64, True, [200, 65, 1, 0]))
# K4/K5 against their plain versions: K2/K3's tolerances (TOL_CTX, TOL_LSE,
# TOL_DQKV_REL), for the same reasons.
# A resumed run's first logged step against the uninterrupted run's: the same
# batch, parameters, optimizer state and random numbers; bf16 tolerance.
TOL_RESUME_REL = 1e-2
# A CUDA graph of N steps against N eager steps from one state: the same
# kernels on the same inputs in the same order, so bit for bit.
TOL_GRAPH_REL = 0.0
# Peak rates of one H100 SXM (NVIDIA's data sheet).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def seeded_model(dtype: str, norm_scheme: str = "post",
                 class_conditioning: str = "initial", layers: int = 1):
    from musicstyletransfer_torch.models import (
        DecoderConfig, EncoderConfig, ModelConfig, StyleVAE, TransformerConfig)

    enc = TransformerConfig(model_size=256, num_layers=2, num_heads=8)
    dec = TransformerConfig(model_size=128, num_layers=layers, num_heads=8,
                            norm_scheme=norm_scheme)
    cfg = ModelConfig(
        encoder_config=EncoderConfig(transformer_config=enc, latent_dim=256),
        decoder_config=DecoderConfig(transformer_config=dec, latent_dim=256,
                                     class_conditioning=class_conditioning),
        dtype=dtype)
    torch.manual_seed(0)
    return StyleVAE(cfg).cuda().eval()


def decode_inputs(model, rows: int, seed: int):
    g = np.random.default_rng(seed)
    latent = model.config.decoder_config.latent_dim
    z = torch.as_tensor(g.normal(size=(rows, latent)), dtype=torch.float32).cuda()
    classes = torch.as_tensor(g.integers(0, 2, rows)).cuda()
    with torch.inference_mode():
        x0 = model.decode_init(z, classes).contiguous()
    return x0, classes


def live_mask(seqs: torch.Tensor) -> torch.Tensor:
    """[B, T] True at generated positions up to and including each row's EOS."""
    from musicstyletransfer_torch.midi.vocab import EOS_ID

    s = seqs.long()
    eos_before = torch.cumsum((s == EOS_ID).long(), dim=1) - (s == EOS_ID).long()
    mask = eos_before == 0
    mask[:, 0] = False
    return mask


def check_kernel(dtype: torch.dtype, fd, decode) -> float:
    """Kernel vs plain version at the canonical decoder shape; returns the
    forced-mode logits' max abs error."""
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    model = seeded_model(name)
    x0, classes = decode_inputs(model, B, seed=1)
    g = np.random.default_rng(2)
    forced = torch.as_tensor(g.integers(3, 293, (B, T)), dtype=torch.int32).cuda()

    _, ks, kl = fd.fused_decode(model, x0, T, 0, mode="forced", forced_tokens=forced)
    _, ps, pl = fd.fused_decode_reference(model, x0, T, 0, mode="forced",
                                          forced_tokens=forced)
    torch.cuda.synchronize()
    err = float((kl - pl).abs().max())
    check(bool(torch.isfinite(kl).all()), f"{name} forced: non-finite logits")
    check(err <= TOL_LOGITS[dtype], f"{name} forced logits max|err| {err} > {TOL_LOGITS[dtype]}")
    serr = float(((ks - ps).abs() / ps.abs()).max())
    check(serr <= TOL_SCORE_REL[dtype], f"{name} forced scores rel err {serr}")
    log(f"[{name}] forced: logits max|err| {err:.3g} (tol {TOL_LOGITS[dtype]}), "
        f"scores max rel err {serr:.3g}")

    kseq, ksc = fd.fused_decode(model, x0, T, 0, mode="greedy")
    pseq, psc = fd.fused_decode_reference(model, x0, T, 0, mode="greedy")
    torch.cuda.synchronize()
    same = float((kseq == pseq).all(dim=1).float().mean())
    if dtype == torch.float32:
        check(same == 1.0, f"float32 greedy: only {same:.3f} of rows identical")
        serr = float(((ksc - psc).abs() / psc.abs()).max())
        check(serr <= TOL_SCORE_REL[dtype], f"float32 greedy scores rel err {serr}")
    # Every greedy token is the argmax of the plain logits on the kernel's
    # own prefix, up to the logits tolerance (exactly so in float32).
    _, _, pl = fd.fused_decode_reference(model, x0, T, 0, mode="forced", forced_tokens=kseq)
    chosen = pl.gather(2, kseq.long()[:, :, None])[:, :, 0]
    gap = (pl.max(-1).values - chosen)[live_mask(kseq)]
    check(float(gap.max()) <= TOL_LOGITS[dtype],
          f"{name} greedy: a token {float(gap.max())} below the plain argmax")
    log(f"[{name}] greedy: {same:.3f} of rows identical, max argmax gap {float(gap.max()):.3g}")

    # Sampling with top-k / top-p: every sampled token lies in the sort-based
    # support of the plain _filter_logits, computed on the kernel's own
    # logits (forced mode re-run on the sampled tokens).
    temp, top_k, top_p = 0.9, 20, 0.9
    kseq, _ = fd.fused_decode(model, x0, T, 7, temp, "sample", top_k=top_k, top_p=top_p)
    _, _, kl = fd.fused_decode(model, x0, T, 0, mode="forced", forced_tokens=kseq)
    keep = decode._filter_logits(kl / temp, top_k, top_p) > -1e29
    inside = keep.gather(2, kseq.long()[:, :, None])[:, :, 0][live_mask(kseq)]
    check(bool(inside.all()), f"{name} top-k/top-p: {int((~inside).sum())} "
          "sampled tokens outside the plain support")
    pseq, _ = fd.fused_decode_reference(model, x0, T, 7, temp, "sample",
                                        top_k=top_k, top_p=top_p)
    torch.cuda.synchronize()
    same = float((kseq == pseq).all(dim=1).float().mean())
    if dtype == torch.float32:  # same Philox draws, same logits
        check(same >= 0.9, f"float32 sample: only {same:.3f} of rows identical")
    log(f"[{name}] top-k/top-p: {int(inside.numel())} sampled tokens all in the "
        f"support; {same:.3f} of rows identical to the plain version's")

    # Sample mode in distribution over 256 rows (different seeds).
    x4, _ = decode_inputs(model, 256, seed=3)
    kseq, ksc = fd.fused_decode(model, x4, T, 11)
    pseq, psc = fd.fused_decode_reference(model, x4, T, 12)
    torch.cuda.synchronize()

    def stats(seqs, scores):
        from musicstyletransfer_torch.midi.vocab import EOS_ID, PAD_ID

        ended = float((seqs == EOS_ID).any(1).float().mean())
        length = float((seqs != PAD_ID).sum(1).float().mean())
        return ended, length, float(scores.mean())

    ke, kn, ks_ = stats(kseq, ksc)
    pe, pn, ps_ = stats(pseq, psc)
    log(f"[{name}] sample x256: EOS rate {ke:.3f} vs {pe:.3f}, mean length "
        f"{kn:.1f} vs {pn:.1f}, mean score {ks_:.2f} vs {ps_:.2f}")
    check(abs(ke - pe) <= 0.15, "EOS termination rate differs by more than 0.15")
    check(abs(kn - pn) <= 0.15 * pn, "mean length differs by more than 15%")
    check(abs(ks_ - ps_) <= 0.15 * abs(ps_), "mean score differs by more than 15%")

    # Pre-LN with a final LayerNorm, per-step class conditioning, two layers.
    model = seeded_model(name, norm_scheme="pre", class_conditioning="per_step", layers=2)
    x0, classes = decode_inputs(model, B, seed=4)
    _, _, kl = fd.fused_decode(model, x0, T, 0, mode="forced", forced_tokens=forced,
                               classes=classes)
    _, _, pl = fd.fused_decode_reference(model, x0, T, 0, mode="forced",
                                         forced_tokens=forced, classes=classes)
    kseq, _ = fd.fused_decode(model, x0, T, 0, mode="greedy", classes=classes)
    pseq, _ = fd.fused_decode_reference(model, x0, T, 0, mode="greedy", classes=classes)
    torch.cuda.synchronize()
    perr = float((kl - pl).abs().max())
    check(perr <= TOL_LOGITS[dtype], f"{name} pre-LN/per_step forced max|err| {perr}")
    same = float((kseq == pseq).all(dim=1).float().mean())
    if dtype == torch.float32:
        check(same == 1.0, f"float32 pre-LN/per_step greedy: {same:.3f} rows identical")
    log(f"[{name}] pre-LN + per_step, 2 layers: forced max|err| {perr:.3g}, "
        f"greedy {same:.3f} of rows identical")
    return err


# Decoders whose widths K1 pads (model size 100 with heads of 25, FF 400) or
# whose vocabulary outgrows the token choice's registers (400 > 320):
# (label, model size, heads, FF multiplier, vocabulary).
LIFTED = (("D=100/H=4/FF=400/V=293", 100, 4, 4, 293), ("D=128/H=8/FF=512/V=400", 128, 8, 4, 400))


def check_lifted(fd, decode, dtype: torch.dtype) -> float:
    """K1 against its plain version at the ``LIFTED`` decoders (64 rows,
    T=130, seeded weights, pre-LN and per-step conditioning on the second):
    forced logits within ``TOL_LOGITS``; greedy and same-seed sampled tokens
    identical (both round at the same places; these seeds' logits keep every
    choice clear of a bf16 tie); top-k/top-p samples inside the plain
    support; each timed once (greedy). Returns the forced logits' largest
    abs error."""
    from musicstyletransfer_torch.models import (
        DecoderConfig, EncoderConfig, ModelConfig, StyleVAE, TransformerConfig)

    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    worst = 0.0
    for i, (label, D, H, mult, V) in enumerate(LIFTED):
        dec = TransformerConfig(model_size=D, num_heads=H, ffn_multiplier=mult, vocab_size=V,
                                norm_scheme="pre" if i else "post")
        cfg = ModelConfig(
            encoder_config=EncoderConfig(transformer_config=TransformerConfig(model_size=64),
                                         latent_dim=64, input_dim=V),
            decoder_config=DecoderConfig(transformer_config=dec, latent_dim=64, output_dim=V,
                                         class_conditioning="per_step" if i else "initial"),
            dtype=name)
        torch.manual_seed(0)
        model = StyleVAE(cfg).cuda().eval()
        g = np.random.default_rng(9)
        z = torch.as_tensor(g.normal(size=(B, 64)), dtype=torch.float32).cuda()
        classes = torch.as_tensor(g.integers(0, 2, B)).cuda()
        with torch.inference_mode():
            x0 = model.decode_init(z, classes).contiguous()
        forced = torch.as_tensor(g.integers(3, V, (B, T)), dtype=torch.int32).cuda()
        _, _, kl = fd.fused_decode(model, x0, T, 0, mode="forced", forced_tokens=forced,
                                   classes=classes)
        _, _, pl = fd.fused_decode_reference(model, x0, T, 0, mode="forced",
                                             forced_tokens=forced, classes=classes)
        kseq, _ = fd.fused_decode(model, x0, T, 0, mode="greedy", classes=classes)
        pseq, _ = fd.fused_decode_reference(model, x0, T, 0, mode="greedy", classes=classes)
        sseq, _ = fd.fused_decode(model, x0, T, 3, classes=classes)
        spseq, _ = fd.fused_decode_reference(model, x0, T, 3, classes=classes)
        temp, top_k, top_p = 0.9, 20, 0.9
        fseq, _ = fd.fused_decode(model, x0, T, 7, temp, "sample", top_k=top_k, top_p=top_p,
                                  classes=classes)
        _, _, fl = fd.fused_decode(model, x0, T, 0, mode="forced", forced_tokens=fseq,
                                   classes=classes)
        torch.cuda.synchronize()
        err = float((kl - pl).abs().max())
        worst = max(worst, err)
        check(bool(torch.isfinite(kl).all()), f"K1 {label} {name}: non-finite logits")
        check(err <= TOL_LOGITS[dtype], f"K1 {label} {name} forced max|err| {err}")
        greedy = float((kseq == pseq).all(dim=1).float().mean())
        sampled = float((sseq == spseq).all(dim=1).float().mean())
        check(greedy == 1.0 and sampled == 1.0,
              f"K1 {label} {name}: greedy {greedy:.3f}, sampled {sampled:.3f} of rows "
              "identical to the plain version's")
        keep = decode._filter_logits(fl / temp, top_k, top_p) > -1e29
        inside = keep.gather(2, fseq.long()[:, :, None])[:, :, 0][live_mask(fseq)]
        check(bool(inside.all()), f"K1 {label} {name}: {int((~inside).sum())} top-k/top-p "
              "tokens outside the plain support")
        ms = time_cuda(lambda: fd.fused_decode(model, x0, T, 0, mode="greedy", classes=classes), 1)
        log(f"[{name}] K1 at {label}, {dec.norm_scheme}-LN, {B} rows, T={T} (plan "
            f"{fd.plan_for(model, B, T)}): forced max|err| {err:.3g} (tol {TOL_LOGITS[dtype]}); "
            f"greedy {greedy:.3f} and same-seed sampled {sampled:.3f} of rows identical; "
            f"{int(inside.numel())} top-k/top-p tokens in the support; greedy {ms:.3f} ms a launch")
    return worst


def check_decoder(fd, dtype: torch.dtype, label: str, dec, latent: int, steps: int,
                  conditioning: str = "initial", reps: int = 3) -> float:
    """K1 at a recipe's decoder ``dec`` over T=``steps`` positions, on 8 rows
    and on 16 (the rows of the generation-health probe and of cli.sample: 8
    sources x 2 classes; the plan groups them differently): forced logits
    against the plain loop, and every greedy token the plain argmax on its
    prefix; then K1's time beside its bound, with the plan that was checked
    and timed. Returns the forced logits' largest abs error."""
    from musicstyletransfer_torch.models import (
        DecoderConfig, EncoderConfig, ModelConfig, StyleVAE, TransformerConfig)

    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    cfg = ModelConfig(
        encoder_config=EncoderConfig(transformer_config=TransformerConfig(model_size=64),
                                     latent_dim=latent),
        decoder_config=DecoderConfig(transformer_config=dec, latent_dim=latent,
                                     class_conditioning=conditioning), dtype=name)
    torch.manual_seed(0)
    model = StyleVAE(cfg).cuda().eval()
    g = np.random.default_rng(5)
    worst = 0.0
    for rows in (8, 16):
        z = torch.as_tensor(g.normal(size=(rows, latent)), dtype=torch.float32).cuda()
        classes = torch.as_tensor(g.integers(0, 2, rows)).cuda()
        with torch.inference_mode():
            x0 = model.decode_init(z, classes).contiguous()
        forced = torch.as_tensor(g.integers(3, 293, (rows, steps)), dtype=torch.int32).cuda()
        _, _, kl = fd.fused_decode(model, x0, steps, 0, mode="forced", forced_tokens=forced,
                                   classes=classes)
        _, _, pl = fd.fused_decode_reference(model, x0, steps, 0, mode="forced",
                                             forced_tokens=forced, classes=classes)
        kseq, _ = fd.fused_decode(model, x0, steps, 0, mode="greedy", classes=classes)
        _, _, gl = fd.fused_decode_reference(model, x0, steps, 0, mode="forced",
                                             forced_tokens=kseq, classes=classes)
        torch.cuda.synchronize()
        err = float((kl - pl).abs().max())
        worst = max(worst, err)
        check(bool(torch.isfinite(kl).all()), f"{label} K1 {name} {rows} rows: non-finite logits")
        check(err <= TOL_LOGITS[dtype],
              f"{label} K1 {name} {rows} rows forced max|err| {err} > {TOL_LOGITS[dtype]}")
        chosen = gl.gather(2, kseq.long()[:, :, None])[:, :, 0]
        gap = float((gl.max(-1).values - chosen)[live_mask(kseq)].max())
        check(gap <= TOL_LOGITS[dtype],
              f"{label} K1 {name} {rows} rows greedy: a token {gap} below the plain argmax")
        ms = time_cuda(lambda: fd.fused_decode(model, x0, steps, 0, mode="greedy",
                                               classes=classes), reps)
        bound_ms, by = k1_bound(model, x0, kseq, steps)
        log(f"[{name}] {label} decoder D={dec.model_size} x{dec.num_layers} layers, "
            f"{dec.num_heads} heads, {dec.norm_scheme}-LN, {conditioning}, T={steps}, {rows} "
            f"rows (plan {fd.plan_for(model, rows, steps)}): forced max|err| {err:.3g} (tol "
            f"{TOL_LOGITS[dtype]}), greedy max argmax gap {gap:.3g}; K1 greedy {ms:.3f} ms a "
            f"launch (bound {bound_ms:.5f} ms, {by})")
    return worst


def core_inputs(T: int, hd: int, dtype: torch.dtype, seed: int, lens=None):
    """qkv [B, T, 16*3*hd], key_lens (by default B=8 ragged ones, a row of 1
    and a row of 0) and a cotangent, seeded with numpy."""
    if lens is None:
        lens = [T, T - 1, 300, 129, 64, 17, 1, 0]
    g = np.random.default_rng(seed)
    qkv = torch.as_tensor(g.normal(size=(len(lens), T, CORE_H * 3 * hd)),
                          dtype=torch.float32).to(dtype).cuda()
    dout = torch.as_tensor(g.normal(size=(len(lens), T, CORE_H * hd)),
                           dtype=torch.float32).to(dtype).cuda()
    return qkv, torch.tensor(lens, dtype=torch.int32).cuda(), dout


def check_core(ac) -> dict:
    """K2 and K3 against their plain versions at both wide shapes and at the
    two short lengths; returns the largest absolute errors {"K2": ...,
    "K3": ...}."""
    worst = {"K2": 0.0, "K3": 0.0}
    cases = [(name, T, hd, causal, None) for name, T, hd, causal in CORE_SHAPES]
    cases += [(name, T, hd, causal, [T, T // 2, 1, 0]) for name, T, hd, causal in CORE_SHORT]
    for name, T, hd, causal, key_lens in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dn = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
            qkv, lens, dout = core_inputs(T, hd, dtype, seed=T + hd, lens=key_lens)
            scale = 1.0 / math.sqrt(hd)
            route = ac.core_route(dtype, hd)
            check(route == ("tensor-core" if dtype == torch.bfloat16 else "cuda-core"),
                  f"K2/K3 {name} T={T} {dn}: routed to the {route} kernels")
            before = counts()
            ctx, lse = ac.core_forward(qkv, lens, CORE_H, causal, scale)
            pctx, plse = ac.core_forward_reference(qkv, lens, CORE_H, causal, scale)
            torch.cuda.synchronize()
            ctx_err = float((ctx.float() - pctx.float()).abs().max())
            masked = plse <= -1e29
            check(bool(torch.equal(lse <= -1e29, masked)), f"K2 {name} {dn}: lse sentinel rows differ")
            lse_err = float((lse - plse)[~masked].abs().max())
            check(bool(torch.isfinite(ctx.float()).all()), f"K2 {name} {dn}: non-finite ctx")
            check(bool((ctx[lens == 0] == 0).all()), f"K2 {name} {dn}: key_lens=0 row not zeros")
            check(ctx_err <= TOL_CTX[dtype], f"K2 {name} {dn}: ctx max|err| {ctx_err} > {TOL_CTX[dtype]}")
            check(lse_err <= TOL_LSE[dtype], f"K2 {name} {dn}: lse max|err| {lse_err} > {TOL_LSE[dtype]}")
            worst["K2"] = max(worst["K2"], ctx_err)
            # K3 on the plain forward's residuals, so only the backward differs.
            line = []
            for label, g in (("dO ~ N(0,1)", dout), ("dO = 1e19", torch.full_like(dout, 1e19))):
                dq = ac.core_backward(qkv, lens, plse, pctx, g, CORE_H, causal, scale)
                pdq = ac.core_backward_reference(qkv, lens, plse, pctx, g, CORE_H, causal, scale)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(dq.float()).all()), f"K3 {name} {dn} {label}: non-finite dqkv")
                err = float((dq.float() - pdq.float()).abs().max())
                rel = err / max(float(pdq.float().abs().max()), 1e-30)
                check(rel <= TOL_DQKV_REL[dtype],
                      f"K3 {name} {dn} {label}: dqkv rel err {rel} > {TOL_DQKV_REL[dtype]}")
                if label.startswith("dO ~"):
                    worst["K3"] = max(worst["K3"], err)
                line.append(f"{label}: max|err| {err:.3g}, rel {rel:.3g}")
            after = counts()
            moved = {k: after[k] - before[k] for k in ("K2", "K2 tc", "K3", "K3 tc")}
            on_tc = int(route == "tensor-core")
            check(moved == {"K2": 1, "K2 tc": on_tc, "K3": 2, "K3 tc": 2 * on_tc},
                  f"K2/K3 {name} T={T} {dn}: launches {moved} on the {route} route")
            log(f"[{dn}] K2 {name} T={T} hd={hd} causal={causal} key_lens={lens.tolist()}: ctx "
                f"max|err| {ctx_err:.3g} (tol {TOL_CTX[dtype]}), lse {lse_err:.3g} (tol "
                f"{TOL_LSE[dtype]}); K3 " + "; ".join(line)
                + f" (rel tol {TOL_DQKV_REL[dtype]}, all finite; {route} kernels)")
    return worst


def flash_inputs(B: int, T: int, hd: int, dtype: torch.dtype, seed: int):
    """q, k, v and a cotangent dO as [B, H, T, hd] views of [B, T, H, hd]
    tensors (the model's layout), and an lse cotangent, seeded with numpy."""
    g = np.random.default_rng(seed)

    def bthd():
        x = torch.as_tensor(g.normal(size=(B, T, FLASH_H, hd)), dtype=torch.float32)
        return x.to(dtype).cuda().transpose(1, 2)

    q, k, v, dout = bthd(), bthd(), bthd(), bthd()
    g_lse = torch.as_tensor(g.normal(size=(B, FLASH_H, T)), dtype=torch.float32).cuda()
    return q, k, v, dout, g_lse


def check_flash(fa, enc_lens) -> dict:
    """K4 and K5 against their plain versions at both long shapes (the corpus
    batch's key lengths ``enc_lens`` plus a row of 1 and a row of 0, +1 in
    the decoder) and at T=8192; returns the largest absolute errors
    {"K4": ..., "K5": ...}."""
    enc = [int(n) for n in enc_lens]
    cases = [(name, T, hd, causal, (enc if name == "encoder" else [n + 1 for n in enc]) + [1, 0])
             for name, T, hd, causal in FLASH_SHAPES]
    cases += [("single row", FLASH_LONG_T, 64, causal, [FLASH_LONG_T * 7 // 8])
              for causal in (False, True)]
    cases += list(FLASH_SHORT)
    worst = {"K4": 0.0, "K5": 0.0}
    for name, T, hd, causal, lens in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dn = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
            tag = f"{name} T={T} hd={hd} causal={causal} {dn}"
            q, k, v, dout, g_lse = flash_inputs(len(lens), T, hd, dtype, seed=T + hd)
            key_lens = torch.tensor(lens, dtype=torch.int32).cuda()
            scale = hd ** -0.5
            route = fa.kernel_route(dtype, hd)
            check(route == ("tensor-core" if dtype == torch.bfloat16 else "cuda-core"),
                  f"K4/K5 {tag}: routed to the {route} kernels")
            before = counts()
            out, lse = fa.flash_forward(q, k, v, key_lens, causal, scale)
            pout, plse = fa.flash_forward_reference(q, k, v, key_lens, causal, scale)
            torch.cuda.synchronize()
            out_err = float((out.float() - pout.float()).abs().max())
            masked = plse <= -1e29
            check(bool(torch.equal(lse <= -1e29, masked)), f"K4 {tag}: lse sentinel rows differ")
            lse_err = float((lse - plse)[~masked].abs().max())
            check(bool(torch.isfinite(out.float()).all()), f"K4 {tag}: non-finite out")
            check(bool((out[key_lens == 0] == 0).all()), f"K4 {tag}: key_lens=0 row not zeros")
            check(out_err <= TOL_CTX[dtype], f"K4 {tag}: out max|err| {out_err} > {TOL_CTX[dtype]}")
            check(lse_err <= TOL_LSE[dtype], f"K4 {tag}: lse max|err| {lse_err} > {TOL_LSE[dtype]}")
            worst["K4"] = max(worst["K4"], out_err)
            # K5 on the plain forward's residuals, so only the backward
            # differs; then through flash_attention_with_lse's autograd on the
            # kernel's own residuals, with an lse cotangent.
            line = []
            x = [t.detach().requires_grad_() for t in (q, k, v)]
            o2, l2 = fa.flash_attention_with_lse(*x, key_lens, causal)
            torch.autograd.backward([o2, l2], [dout, g_lse])
            runs = (("dO ~ N(0,1)", dout, None, plse, pout, None),
                    ("with g_lse", dout, g_lse, plse, pout, None),
                    ("dO = 1e19", torch.full_like(dout, 1e19), None, plse, pout, None),
                    ("autograd, with g_lse", dout, g_lse, l2.detach(), o2.detach(),
                     [t.grad for t in x]))
            for label, g, gl, lse_r, out_r, grads in runs:
                if grads is None:
                    grads = fa.flash_backward(q, k, v, key_lens, lse_r, out_r, g, causal, scale, gl)
                    again = fa.flash_backward(q, k, v, key_lens, lse_r, out_r, g, causal, scale, gl)
                    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                          f"K5 {tag} {label}: two runs differ")
                pgrads = fa.flash_backward_reference(q, k, v, key_lens, lse_r, out_r, g, causal,
                                                     scale, gl)
                torch.cuda.synchronize()
                errs, rels = [], []
                for gname, d, pd in zip("qkv", grads, pgrads):
                    check(bool(torch.isfinite(d.float()).all()), f"K5 {tag} {label}: non-finite d{gname}")
                    errs.append(float((d.float() - pd.float()).abs().max()))
                    rels.append(errs[-1] / max(float(pd.float().abs().max()), 1e-30))
                check(max(rels) <= TOL_DQKV_REL[dtype],
                      f"K5 {tag} {label}: rel errs {rels} > {TOL_DQKV_REL[dtype]}")
                if label != "dO = 1e19":
                    worst["K5"] = max(worst["K5"], max(errs))
                line.append(f"{label}: max|err| {max(errs):.3g}, rel {max(rels):.3g}")
            after = counts()
            moved = {k: after[k] - before[k] for k in ("K4", "K4 tc", "K5", "K5 tc")}
            on_tc = route == "tensor-core"
            check(moved["K4"] == 2 and moved["K5"] == 7
                  and moved["K4 tc"] == (2 if on_tc else 0) and moved["K5 tc"] == (7 if on_tc else 0),
                  f"K4/K5 {tag}: launches {moved} on the {route} route")
            log(f"[{dn}] K4 {name} T={T} hd={hd} causal={causal} key_lens={lens}: out max|err| "
                f"{out_err:.3g} (tol {TOL_CTX[dtype]}), lse {lse_err:.3g} (tol {TOL_LSE[dtype]}); "
                "K5 " + "; ".join(line) + f" (rel tol {TOL_DQKV_REL[dtype]}, all finite, "
                f"two runs identical; {route} kernels)")
    return worst


def recipe_argv(script: str, data: str, model_output: str, out_samples: str,
                required=("--use-flash-attention", "--max-seq-len", "--batch-size"),
                module: str = "main"):
    """scripts/<script>'s flags to ``cli.<module>``, shell defaults
    (${TP:-1}) taken, with its paths replaced; each of ``required`` must be
    among them."""
    with open(os.path.join(REPO, "scripts", script)) as f:
        text = f.read()
    body = text.split(f"musicstyletransfer_tpu.cli.{module}", 1)[1].split('"$@"', 1)[0]
    body = re.sub(r"\$\{\w+:-([^}]*)\}", r"\1", body)
    body = re.sub(r"\$\{\w+:\+[^}]*\}", "", body)  # ${X:+...} with X unset
    argv = shlex.split(body.replace("\\\n", " "))
    subs = {"--data": data, "--model-output": model_output, "--out-samples": out_samples}
    for i, a in enumerate(argv[:-1]):
        if a in subs:
            argv[i + 1] = subs[a]
    # a flag still given only a shell variable ("--dist-process-id
    # "$PROCESS_ID"") is the launcher's to set: left out
    argv = [a for i, a in enumerate(argv) if not a.startswith("$")
            and not (i + 1 < len(argv) and argv[i + 1].startswith("$"))]
    for flag in required:
        check(flag in argv, f"{script} lost {flag}")
    return argv


def counts(reset: bool = False) -> dict:
    """Launch counts of K1-K5 (K2-K5 also on their tensor-core kernels
    alone) and runs of their plain versions on CUDA (``ops.counters``)."""
    from musicstyletransfer_torch.ops import counters

    out = counters.read()
    if reset:
        counters.reset()
    return out


def train_lines(path: str):
    with open(path) as f:
        lines = [json.loads(x) for x in f]
    return lines


def check_train_log(lines, label: str, guarded: bool = True) -> None:
    """Finite losses and gradient norms at every logged step, and, where
    the recipe has the non-finite guard (``guarded``), no skipped update."""
    train = [x for x in lines if "grad_norm" in x]
    check(train, f"{label}: no training metrics logged")
    for x in train:
        for k in ("ce_loss", "total_loss", "grad_norm"):
            check(isinstance(x[k], float) and math.isfinite(x[k]),
                  f"{label}: {k} at step {x['step']} is {x[k]}")
    skipped = [x["nonfinite_updates_skipped"] for x in lines if "nonfinite_updates_skipped" in x]
    check(bool(skipped) == guarded and all(v == 0 for v in skipped),
          f"{label}: skipped updates {skipped}")


def train_path(ac, fd, tmp: str) -> dict:
    """The wide recipe through cli.main, a resumed run, and cli.sample."""
    from musicstyletransfer_torch.cli import main as cli_main
    from musicstyletransfer_torch.cli import sample as cli_sample
    from musicstyletransfer_torch.data import Loader, MelodyDataset, load_dataset
    from musicstyletransfer_torch.ops import counters

    data = os.path.join(REPO, "work", "data", "guitar_bass")
    loader = Loader(data, 512)
    per_epoch = load_dataset(loader, 8, 0.1)[0].num_batches()
    u, r = os.path.join(tmp, "wide"), os.path.join(tmp, "wide-resumed")

    def argv(model, epochs):
        return recipe_argv("train-vae-wide.sh", data, model, os.path.join(tmp, "out-wide")) + [
            "--epochs", str(epochs), "--checkpoint-frequency", str(per_epoch),
            "--logdir", model + "-log", "--log-every", "1"]

    layers = 4 + 2  # the recipe's encoder and decoder layers
    counts(reset=True)
    t0 = time.perf_counter()
    cli_main.main(argv(u, 2))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = counts()
    steps = 2 * per_epoch
    log(f"train path: cli.main, wide recipe, {steps} steps in {wall:.1f} s (2 checkpoints, "
        f"validation, generation-health probe); launches {c}")
    lines_u = train_lines(os.path.join(u + "-log", "scalars.jsonl"))
    check_train_log(lines_u, "wide run")
    check(c["K3"] == layers * steps, f"K3 launched {c['K3']} times, expected {layers} x {steps}")
    check(c["K2"] >= c["K3"], f"K2 launched {c['K2']} times, fewer than K3")
    check(c["K2 tc"] == c["K2"] and c["K3 tc"] == c["K3"],
          f"the wide path left the tensor-core kernels: {c}")
    check(c["K1"] > 0, "the generation-health probe did not launch K1")
    for k in counters.PLAIN:
        check(c[k] == 0, f"{k} ran {c[k]} times on CUDA in the training path")
    main_counts = c

    # Resume: a copy of the run as it stood at its first checkpoint.
    shutil.copytree(u, r, ignore=shutil.ignore_patterns("params.2.pt"))
    counts(reset=True)
    cli_main.main(argv(r, 1))
    torch.cuda.synchronize()
    c = counts()
    lines_r = train_lines(os.path.join(r + "-log", "scalars.jsonl"))
    check_train_log(lines_r, "resumed run")
    check(c["K3"] == layers * per_epoch and c["K3 tc"] == c["K3"] and c["K2 tc"] == c["K2"],
          f"resumed: launches {c}")
    first = next(x for x in lines_r if "grad_norm" in x)
    same = next(x for x in lines_u if "grad_norm" in x and x["step"] == first["step"])
    diffs = {k: abs(first[k] - same[k]) / max(abs(same[k]), 1e-12)
             for k in ("ce_loss", "kl_loss", "total_loss", "grad_norm")}
    check(max(diffs.values()) <= TOL_RESUME_REL,
          f"resumed step {first['step']} differs from the uninterrupted run: {diffs}")
    log(f"resume: step {first['step']} ce_loss {first['ce_loss']:.6f} vs {same['ce_loss']:.6f} "
        f"uninterrupted, grad_norm {first['grad_norm']:.6f} vs {same['grad_norm']:.6f}; "
        f"max rel diff {max(diffs.values()):.3g} (tol {TOL_RESUME_REL})")

    # Sample from the resumed run's checkpoint.
    out = os.path.join(tmp, "samples-wide")
    counts(reset=True)
    t0 = time.perf_counter()
    cli_sample.main(["--model-output", r, "--checkpoint", "-1", "--data", data,
                     "--out-samples", out, "--batch-size", "8", "--max-seq-len", "512"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = counts()
    names, notes = parse_midi_dir(out)
    expected = 3 * 8 * MelodyDataset(8, 512, loader.melodies).num_batches()
    check(len(names) == expected, f"cli.sample wrote {len(names)} files, expected {expected}")
    check(c["K1"] > 0 and c["K2"] > 0 and c["K2 tc"] == c["K2"], f"cli.sample launches {c}")
    for k in counters.PLAIN:
        check(c[k] == 0, f"{k} ran {c[k]} times on CUDA in cli.sample")
    log(f"sample path: cli.sample on the resumed checkpoint, max_len 1026: {len(names)} MIDI "
        f"files written and parsed back ({notes} note events) in {wall:.1f} s; launches {c}")
    return main_counts


def canonical_path(tmp: str) -> dict:
    """The canonical recipe (scripts/train-vae.sh: models/guitar_bass's
    widths, batch 32, L=64, bf16 activations, groups of 8 steps) through
    cli.main for two epochs, each group one CUDA-graph replay; then
    cli.evaluate --transfer-stats on the folder it wrote, and cli.sample
    with beam search and with sampling on it (two files of the corpus).
    Returns the training run's launch counts."""
    import contextlib
    import io

    from musicstyletransfer_torch.cli import evaluate as cli_evaluate
    from musicstyletransfer_torch.cli import main as cli_main
    from musicstyletransfer_torch.cli import sample as cli_sample
    from musicstyletransfer_torch.data import Loader, load_dataset
    from musicstyletransfer_torch.ops import counters
    from musicstyletransfer_torch.training.graph import GraphedSteps

    data = os.path.join(REPO, "work", "data", "guitar_bass")
    per_epoch = load_dataset(Loader(data, L), 32, 0.0)[0].num_batches()
    model = os.path.join(tmp, "canonical")
    argv = recipe_argv("train-vae.sh", data, model, os.path.join(tmp, "out-canonical"),
                       required=("--max-seq-len", "--batch-size", "--steps-per-dispatch")) + [
        "--epochs", "2", "--checkpoint-frequency", str(per_epoch),
        "--logdir", model + "-log", "--log-every", "8"]
    check("--steps-per-dispatch" in argv and argv[argv.index("--steps-per-dispatch") + 1] == "8",
          "train-vae.sh lost --steps-per-dispatch 8")
    counters.reset()
    replays, captures = GraphedSteps.replays, GraphedSteps.captures
    t0 = time.perf_counter()
    cli_main.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = counters.read()
    groups = 2 * -(-per_epoch // 8)
    replays, captures = GraphedSteps.replays - replays, GraphedSteps.captures - captures
    log(f"canonical path: cli.main, train-vae.sh, {2 * per_epoch} steps in {wall:.1f} s as "
        f"{replays} CUDA-graph replays ({captures} captures: groups of 8 and the epoch's "
        f"remainder of {per_epoch % 8}); launches {c}")
    check(replays == groups and captures == 1 + (per_epoch % 8 > 0),
          f"expected {groups} replays, got {replays} ({captures} captures)")
    lines = train_lines(os.path.join(model + "-log", "scalars.jsonl"))
    check_train_log(lines, "canonical run", guarded=False)
    with open(os.path.join(model, "train_state.json")) as f:
        check(json.load(f)["n_batches"] == 2 * per_epoch, "canonical run: wrong batch count")
    check(c["K1"] > 0, "the generation-health probe did not launch K1")
    for k in counters.PLAIN:
        check(c[k] == 0, f"{k} ran {c[k]} times on CUDA in the canonical training path")
    main_counts = c

    out = io.StringIO()
    counters.reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli_evaluate.main(["--model-output", model, "--data", data, "--transfer-stats"])
    vals = json.loads(out.getvalue().strip().splitlines()[-1])
    c = counters.read()
    for k in ("ppl", "acc", "total_loss", "termination_rate", "pitch_js_to_own_source",
              "octave_js_to_target_class"):
        check(k in vals and math.isfinite(vals[k]), f"cli.evaluate: {k} missing or not finite")
    check(vals["transfer_sequences"] == 2 * 4 * 32 and c["K1"] == 4 and c["K1 plain"] == 0,
          f"cli.evaluate --transfer-stats: {vals['transfer_sequences']} sequences, launches {c}")
    log(f"evaluate path: cli.evaluate --transfer-stats in {time.perf_counter() - t0:.1f} s: "
        + json.dumps(vals))

    small = os.path.join(tmp, "two-files")
    for cls, name in (("bass", "Until_It_Sleeps_2_Bass-Guitar.mid"),
                      ("guitar", "Metal_Militia_Guitar-3.mid")):
        os.makedirs(os.path.join(small, cls))
        shutil.copy(os.path.join(data, cls, name), os.path.join(small, cls, name))
    for kind in ("beam-search", "sampling"):
        dst = os.path.join(tmp, f"samples-canonical-{kind}")
        counters.reset()
        t0 = time.perf_counter()
        cli_sample.main(["--model-output", model, "--checkpoint", "-1", "--data", small,
                         "--out-samples", dst, "--sampling-type", kind, "--batch-size", "32",
                         "--max-seq-len", str(L)])
        torch.cuda.synchronize()
        c = counters.read()
        names, notes = parse_midi_dir(dst)
        check(names and len(names) % 3 == 0, f"cli.sample {kind} wrote {len(names)} files")
        check((c["K1"] > 0) == (kind == "sampling") and c["K1 plain"] == 0,
              f"cli.sample {kind}: launches {c}")
        log(f"sample path ({kind}): cli.sample on the canonical checkpoint: {len(names)} MIDI "
            f"files written and parsed back ({notes} note events) in "
            f"{time.perf_counter() - t0:.1f} s; K1 launches {c['K1']}")
    return main_counts


def long_path(tmp: str) -> dict:
    """The long recipe through cli.main for two epochs, then cli.sample on its
    checkpoint at max_len 2 * (L + 1) = 4094; returns the training run's
    launch counts."""
    from musicstyletransfer_torch.cli import main as cli_main
    from musicstyletransfer_torch.cli import sample as cli_sample
    from musicstyletransfer_torch.data import Loader, MelodyDataset, load_dataset
    from musicstyletransfer_torch.ops import counters

    data = os.path.join(REPO, "work", "data", "guitar_bass")
    loader = Loader(data, LONG_L)
    per_epoch = load_dataset(loader, LONG_B, 0.1)[0].num_batches()
    model = os.path.join(tmp, "long")
    argv = recipe_argv("train-vae-long.sh", data, model, os.path.join(tmp, "out-long")) + [
        "--epochs", "2", "--checkpoint-frequency", str(per_epoch),
        "--logdir", model + "-log", "--log-every", "1"]
    for flag in ("--ring-attention", "--class-conditioning", "--free-bits"):
        check(flag in argv, f"train-vae-long.sh lost {flag}")
    layers = 4 + 2  # the recipe's encoder and decoder layers
    counts(reset=True)
    t0 = time.perf_counter()
    cli_main.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = counts()
    steps = 2 * per_epoch
    log(f"long path: cli.main, long recipe, {steps} steps in {wall:.1f} s (2 checkpoints, "
        f"validation, generation-health probe at max_len {2 * (LONG_L + 1)}); launches {c}")
    check_train_log(train_lines(os.path.join(model + "-log", "scalars.jsonl")), "long run")
    check(c["K5"] == layers * steps, f"K5 launched {c['K5']} times, expected {layers} x {steps}")
    check(c["K4"] >= c["K5"], f"K4 launched {c['K4']} times, fewer than K5")
    check(c["K4 tc"] == c["K4"] and c["K5 tc"] == c["K5"],
          f"the long path left the tensor-core kernels: {c}")
    check(c["K2"] == 0 and c["K3"] == 0, f"the long path launched K2/K3: {c}")
    check(c["K1"] > 0, "the generation-health probe did not launch K1")
    for k in counters.PLAIN:
        check(c[k] == 0, f"{k} ran {c[k]} times on CUDA in the long training path")
    main_counts = c

    out = os.path.join(tmp, "samples-long")
    counts(reset=True)
    t0 = time.perf_counter()
    cli_sample.main(["--model-output", model, "--checkpoint", "-1", "--data", data,
                     "--out-samples", out, "--batch-size", "8", "--max-seq-len", str(LONG_L)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = counts()
    names, notes = parse_midi_dir(out)
    expected = 3 * 8 * MelodyDataset(8, LONG_L, loader.melodies).num_batches()
    check(len(names) == expected, f"cli.sample wrote {len(names)} files, expected {expected}")
    check(c["K1"] > 0 and c["K4"] > 0 and c["K4 tc"] == c["K4"] and c["K2"] == 0,
          f"cli.sample launches {c}")
    for k in counters.PLAIN:
        check(c[k] == 0, f"{k} ran {c[k]} times on CUDA in cli.sample")
    log(f"long sample path: cli.sample on the long checkpoint, max_len {2 * (LONG_L + 1)}: "
        f"{len(names)} MIDI files written and parsed back ({notes} note events) in {wall:.1f} s; "
        f"launches {c}")
    return main_counts


# ----------------------------------------------------------------------------
# The GAN family and the LSTM decoder (no hand kernel runs on either path)

GAN_MODEL = os.path.join(REPO, "models", "gan_guitar_bass")
GAN_K = 5  # train-gan.sh's --discriminator-update-steps
GAN_CHAIN = {"eager": 10, "graphed": 100}  # batches a timed chain
GAN_CHAINS = {"eager": 1, "graphed": 5}  # timed chains a mode (eager: one, for the time limit)


def gan_argv(data: str, model_output: str, out_samples: str):
    return recipe_argv("train-gan.sh", data, model_output, out_samples,
                       required=("--batch-size", "--max-seq-len",
                                 "--discriminator-update-steps", "--sampling-frequency"),
                       module="gan")


def gan_setup(r1_gamma: float, seed: int = 0, mesh=None, dtype: str = "bfloat16"):
    """train-gan.sh's GAN (seeded weights, on the card) as cli.gan builds
    it, with ``r1_gamma`` (on ``mesh``, in ``dtype``): (args, GANSteps)."""
    from musicstyletransfer_torch.cli import gan as cli_gan
    from musicstyletransfer_torch.midi.vocab import NUM_EVENTS
    from musicstyletransfer_torch.models.gan import init_gan_params
    from musicstyletransfer_torch.training.gan_trainer import GANSteps

    args = cli_gan.get_gan_config(gan_argv("-", "-", "-"))
    config = cli_gan.create_gan_config(args, 2, NUM_EVENTS, args.max_seq_len)
    tc = cli_gan.create_gan_train_config(args)
    check(tc.discriminator_update_steps == GAN_K and config.dtype == "bfloat16",
          f"train-gan.sh: {tc}, {config.dtype}")
    import dataclasses

    tc = dataclasses.replace(tc, r1_gamma=r1_gamma)
    config = dataclasses.replace(config, dtype=dtype)
    gen, disc = init_gan_params(config, seed)
    steps = GANSteps(config, tc, gen.cuda(), disc.cuda(),
                     torch.Generator(device="cuda").manual_seed(seed), mesh)
    return args, steps


def gan_graph_vs_eager(batches) -> None:
    """Two groups of train-gan.sh's steps (D,G,D,D,D,D twice: 10 D and 2 G
    updates) from one seeded state, as eager steps and as two replays of one
    CUDA graph (GraphedGANGroups), at r1_gamma 0.1 and 0: both models'
    parameters, Adam state, the metric sums and the noise generator bit for
    bit."""
    for r1 in (0.1, 0.0):
        runs = [gan_groups(r1, graphed, batches) for graphed in (False, True)]
        same = [torch.equal(a, b) for a, b in zip(*runs)]
        check(all(same), f"GAN r1_gamma={r1}: graphed groups differ from eager steps: {same}")
        log(f"GAN graph vs eager (train-gan.sh: B=32, L=64, bf16, G/D 1x256), r1_gamma {r1}: "
            "2 groups (10 D, 2 G updates) bit for bit identical (G and D parameters, Adam "
            "moments and counts, metric sums, noise generator)")


def gan_groups(r1: float, graphed: bool, batches, mesh=None):
    """Two groups of train-gan.sh's steps (10 D and 2 G updates) from the
    seeded state, eager or as CUDA-graph replays, on ``mesh``: every tensor
    the steps update and the noise generator's state, afterwards."""
    from musicstyletransfer_torch.training.gan_trainer import (GraphedGANGroups, batch_tensors,
                                                               group_pattern)

    _, steps = gan_setup(r1, mesh=mesh)
    tensors = [batch_tensors(b, "cuda") for b in batches[:2 * GAN_K]]
    graphs = GraphedGANGroups(steps, GAN_K) if graphed else None
    for i in range(2):
        group = tensors[i * GAN_K:(i + 1) * GAN_K]
        pattern = group_pattern(i * GAN_K, GAN_K, GAN_K)
        if graphed:
            graphs.run(group, pattern)
        else:
            steps.run_group(group, pattern)
    torch.cuda.synchronize()
    counts = (int(steps.d_opt.state["count"]), int(steps.g_opt.state["count"]))
    check(counts == (2 * GAN_K, 2), f"GAN updates {counts}, expected (10, 2)")
    return ([t.clone() for t in steps.tensors()]
            + [steps.generator.get_state().to(torch.int64).cuda()])


def run_cli(module: str, argv, timeout: float = 600):
    """``python -m musicstyletransfer_torch.cli.<module> argv`` as a process
    from the repository's root; its standard output (fails on a non-zero
    exit)."""
    proc = subprocess.run([sys.executable, "-m", f"musicstyletransfer_torch.cli.{module}",
                           *argv], cwd=REPO, capture_output=True, text=True, timeout=timeout)
    check(proc.returncode == 0, f"cli.{module} {' '.join(argv)} exited {proc.returncode}:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout


def gan_rates(batches, card: str) -> dict:
    """bench.py's GAN protocol on the card: updates (batches) a second with a
    G update after every 5th batch's D update, B=32, train-gan.sh's model,
    one fixed batch, the median of GAN_CHAINS interleaved chains, at r1_gamma
    0 and 0.1, eager (chains of GAN_CHAIN["eager"] batches) and as graph replays
    of groups of 5 (chains of GAN_CHAIN["graphed"]); each chain ends in one host
    read of a metric sum. Then torch.profiler windows (eager: a D step and a
    G step apart; graphed: one replay): host ops and kernels an update, the
    device's busy share."""
    from musicstyletransfer_torch.training.gan_trainer import (GraphedGANGroups, batch_tensors,
                                                               group_pattern)

    batch = batch_tensors(batches[0], "cuda")
    pattern = group_pattern(0, GAN_K, GAN_K)
    runners = {}
    for r1 in (0.0, 0.1):
        _, steps = gan_setup(r1)
        graphs = GraphedGANGroups(steps, GAN_K)

        def eager(n, steps=steps):
            for i in range(0, n, GAN_K):
                steps.run_group([batch] * GAN_K, pattern)

        def graphed(n, graphs=graphs):
            for i in range(0, n, GAN_K):
                graphs.run([batch] * GAN_K, pattern)

        runners[("eager", r1)] = (eager, steps)
        runners[("graphed", r1)] = (graphed, steps)

    def chain(key):
        fn, steps = runners[key]
        n = GAN_CHAIN[key[0]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(n)
        float(steps.sums[0])  # waits for the chain
        return n / (time.perf_counter() - t0)

    t0 = time.perf_counter()
    for key in runners:
        runners[key][0](GAN_K)  # warm-up, capture
    log(f"gan rates: warm-ups and captures {time.perf_counter() - t0:.1f} s")
    rates = {key: [] for key in runners}
    for i in range(max(GAN_CHAINS.values())):
        for key in runners:
            if i < GAN_CHAINS[key[0]]:
                rates[key].append(chain(key))
    log(f"gan rates: chains done after {time.perf_counter() - t0:.1f} s")
    res = {}
    for key, (fn, steps) in runners.items():
        mode, r1 = key
        if mode == "eager":  # a D step and a G step apart: a group's ~270k events take long to sum
            d = profiled(lambda: steps.d_step(*batch))
            g = profiled(lambda: steps.g_step(batch[1]))
            kernel_ms, wall, kernels, host_ops = (a + b / GAN_K for a, b in zip(d, g))
            window = "a D step and a G step, weighted 1 : 1/5"
        else:
            kernel_ms, wall, kernels, host_ops = (x / GAN_K for x in profiled(lambda: fn(GAN_K)))
            window = f"one replay of {GAN_K} updates"
        r = {"updates_per_s": statistics.median(rates[key]), "rates": rates[key],
             "kernel_ms": kernel_ms, "busy": kernel_ms / max(wall, 1e-9),
             "kernels": kernels, "host_ops": host_ops}
        res[f"{mode} r1={r1}"] = r
        log(f"GAN training {mode}, r1_gamma {r1} (train-gan.sh: B=32, L=64, bf16, D:G 5:1): "
            f"median {r['updates_per_s']:.2f} updates/s over {GAN_CHAINS[mode]} chain(s) of "
            f"{GAN_CHAIN[mode]} "
            f"({', '.join(f'{x:.2f}' for x in rates[key])}); profiler ({window}): "
            f"{r['kernel_ms']:.3f} ms of kernels an update, device busy {r['busy']:.3f}, "
            f"{r['kernels']:.0f} kernels and {r['host_ops']:.0f} host ops an update; on {card}")
    return res


def profiled(fn):
    """(kernel ms, wall ms, kernels, host ops) of one call of fn, from
    torch.profiler (device-side events for the kernels)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
    events = prof.key_averages()
    dev = [e for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    host = [e for e in events if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA]
    return (sum(getattr(e, "self_device_time_total", 0.0) for e in dev) / 1e3, wall,
            sum(e.count for e in dev), sum(e.count for e in host))


def gan_path(tmp: str, batches, card: str) -> dict:
    """The GAN family on the card: graphed groups against eager steps;
    cli.gan with train-gan.sh's flags for 2 epochs (a checkpoint after each,
    the sampling tick at batch 50) as a process, and a second process that
    resumes from its last checkpoint; cli.gan --generate 16 on that folder
    and on the shipped models/gan_guitar_bass, whose classes must separate;
    the shipped generator's float32 hard rollout on the card against the
    same rollout on the CPU; then the updates/s of gan_rates."""
    from musicstyletransfer_torch.cli import gan as cli_gan
    from musicstyletransfer_torch.data import Loader, load_dataset
    from musicstyletransfer_torch.inference.quality import js_divergence, octave_histogram
    from musicstyletransfer_torch.midi.vocab import is_note_on
    from musicstyletransfer_torch.ops import counters

    t_phase = time.perf_counter()
    counters.reset()
    gan_graph_vs_eager(batches)
    data = os.path.join(REPO, "work", "data", "guitar_bass")
    per_epoch = load_dataset(Loader(data, L), 32, 0.0)[0].num_batches()
    model, out = os.path.join(tmp, "gan"), os.path.join(tmp, "gan-out")
    argv = gan_argv(data, model, out) + ["--checkpoint-frequency", str(per_epoch),
                                         "--logdir", model + "-log"]
    check(argv[argv.index("--sampling-frequency") + 1] == "50", "train-gan.sh lost its 50")
    t0 = time.perf_counter()
    text = run_cli("gan", argv + ["--epochs", "2"])
    wall = time.perf_counter() - t0
    check(os.listdir(out) == ["step-50"], f"sampling ticks {os.listdir(out)}")
    names, notes = parse_midi_dir(os.path.join(out, "step-50"))
    check(sorted(names) == sorted(f"gan-out-{i}.class-{c}.mid" for i in range(8)
                                  for c in range(2)), f"GAN samples {names}")
    check(sorted(os.listdir(os.path.join(model, "generator"))) == [
        "params.1.pt", "params.2.pt", "params.3.pt"], "GAN checkpoints")
    logged = [json.loads(x) for x in open(os.path.join(model + "-log", "scalars.jsonl"))]
    check([x["step"] for x in logged] == [50, 2 * per_epoch] and all(
        math.isfinite(v) for x in logged for v in x.values()), f"GAN scalars {logged}")
    log(f"gan path: cli.gan, train-gan.sh, {2 * per_epoch} batches ({2 * per_epoch} D and "
        f"{-(-2 * per_epoch // GAN_K)} G updates) as a process in {wall:.1f} s; sampling tick "
        f"at 50: {len(names)} MIDI files parsed back ({notes} note events); scalars "
        + json.dumps(logged))
    text = run_cli("gan", argv + ["--epochs", "1"])
    check("resumed GAN from checkpoint 3" in text, "the second cli.gan run did not resume")
    check(sorted(os.listdir(os.path.join(model, "generator")))[-1] == "params.5.pt",
          "the resumed run's checkpoints")
    log("gan path: a second cli.gan process resumed from checkpoint 3 and wrote 4-5")

    import contextlib
    import io

    stats = {}
    for label, folder in (("trained", model), ("shipped", GAN_MODEL)):
        dst = os.path.join(tmp, f"gan-gen-{label}")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            cli_gan.main(["--generate", "16", "--model-output", folder, "--out-samples", dst,
                          "--data", data])
        stats[label] = json.loads(text.getvalue().strip().splitlines()[-1])
        names, _ = parse_midi_dir(dst)
        check(len(names) == 32, f"--generate 16 on {label}: {len(names)} files")
        log(f"gan --generate 16 ({label}): " + json.dumps(stats[label]))

    # the shipped generator in process: both classes separate; float32 card == CPU
    config, gen, _ = cli_gan.load_generator(GAN_MODEL, -1, torch.device("cuda"))
    loader = Loader(data, L)
    corpus = {i: [m.tokens for m in loader.melodies[name]]
              for i, name in enumerate(sorted(loader.melodies))}
    from musicstyletransfer_torch.models.gan import generate_tokens

    for c in range(2):
        rows = generate_tokens(gen, torch.full((16,), c, device="cuda"),
                               torch.Generator(device="cuda").manual_seed(100 + c)).cpu().numpy()
        ons = float(np.mean([is_note_on(int(t)) for t in rows.ravel()]))
        own = js_divergence(octave_histogram(list(rows)), octave_histogram(corpus[c]))
        other = js_divergence(octave_histogram(list(rows)), octave_histogram(corpus[1 - c]))
        check(ons > 0.1 and own < other,
              f"shipped generator class {c}: note-on {ons}, octave JS own {own} other {other}")
        log(f"shipped generator on the card, class {c}, 16 rows: note-on fraction {ons:.3f}, "
            f"octave JS own {own:.4f} < other {other:.4f}")
    import dataclasses

    from musicstyletransfer_torch.models.gan import gumbel, make_generator

    g32 = make_generator(dataclasses.replace(config, dtype="float32"))
    g32.load_state_dict(gen.state_dict())
    g32.eval()
    draws = torch.Generator().manual_seed(4)
    gc = config.generator_config
    noise = torch.randn((16, gc.max_seq_len, gc.noise_dim), generator=draws)
    gumbels = gumbel((gc.max_seq_len, 16, gc.output_dim), draws, "cpu")
    classes = torch.arange(16) % 2
    with torch.no_grad():
        _, cpu_tokens = g32(noise, classes, hard=True, gumbel_noise=gumbels)
        g32.cuda()
        _, card_tokens = g32(noise.cuda(), classes.cuda(), hard=True, gumbel_noise=gumbels.cuda())
    check(torch.equal(cpu_tokens, card_tokens.cpu()),
          f"shipped generator float32: {int((cpu_tokens != card_tokens.cpu()).sum())} tokens "
          "differ between the card and the CPU")
    log("shipped generator float32 hard rollout (16 rows x 64 steps, fixed noise and Gumbel "
        "draws): the card's tokens equal the CPU's, token for token")
    log(f"gan path: checks done after {time.perf_counter() - t_phase:.1f} s")
    t0 = time.perf_counter()
    rates = gan_rates(batches, card)
    c = counters.read()
    check(all(v == 0 for v in c.values()), f"the GAN path launched a hand kernel: {c}")
    log(f"gan path: {time.perf_counter() - t_phase:.1f} s (the rates {time.perf_counter() - t0:.1f} s)")
    return rates


def lstm_path(tmp: str, canonical_batches, card: str) -> dict:
    """The LSTM-decoder VAE (train-vae.sh --decoder-type lstm: encoder
    2x256, latent 256, decoder LSTM 1x128 with dropout 0.2, B=32, L=64,
    groups of 8 steps): graphs against eager steps over 2 groups; cli.main
    for one epoch (graph replays); cli.sample with sampling and with beam
    search; cli.evaluate --transfer-stats; the step loop's decode timed at
    the serving shape (B=64, T=130); K1 launched 0 times in the phase."""
    import contextlib
    import io

    from musicstyletransfer_torch.cli import evaluate as cli_evaluate
    from musicstyletransfer_torch.cli import main as cli_main
    from musicstyletransfer_torch.cli import sample as cli_sample
    from musicstyletransfer_torch.data import Loader, load_dataset
    from musicstyletransfer_torch.inference import decode
    from musicstyletransfer_torch.inference.sampler import load_inference_model
    from musicstyletransfer_torch.ops import counters
    from musicstyletransfer_torch.training.graph import GraphedSteps

    t_phase = time.perf_counter()
    lstm = ("--decoder-type", "lstm")
    counters.reset()
    graph_vs_eager("train-vae.sh", canonical_batches, (8, 8), extra=lstm)
    data = os.path.join(REPO, "work", "data", "guitar_bass")
    per_epoch = load_dataset(Loader(data, L), 32, 0.0)[0].num_batches()
    model = os.path.join(tmp, "lstm")
    argv = recipe_argv("train-vae.sh", data, model, os.path.join(tmp, "out-lstm"),
                       required=("--max-seq-len", "--batch-size", "--steps-per-dispatch")) + [
        *lstm, "--epochs", "1", "--logdir", model + "-log", "--log-every", "8"]
    replays = GraphedSteps.replays
    t0 = time.perf_counter()
    cli_main.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    replays = GraphedSteps.replays - replays
    check(replays == -(-per_epoch // 8), f"cli.main --decoder-type lstm: {replays} replays")
    check_train_log(train_lines(os.path.join(model + "-log", "scalars.jsonl")), "LSTM run",
                    guarded=False)
    with open(os.path.join(model, "torch", "config.json")) as f:
        dc = json.load(f)["model_config"]["decoder_config"]
    check(dc["decoder_type"] == "lstm" and dc["lstm_config"] == {
        "n_layers": 1, "hidden_dim": 128, "dropout": 0.2}, f"LSTM export {dc}")
    log(f"lstm path: cli.main train-vae.sh --decoder-type lstm, {per_epoch} steps in "
        f"{wall:.1f} s as {replays} CUDA-graph replays (checkpoint, generation-health probe "
        "through the step loop)")

    small = os.path.join(tmp, "lstm-two-files")
    for cls, name in (("bass", "Until_It_Sleeps_2_Bass-Guitar.mid"),
                      ("guitar", "Metal_Militia_Guitar-3.mid")):
        os.makedirs(os.path.join(small, cls))
        shutil.copy(os.path.join(data, cls, name), os.path.join(small, cls, name))
    for kind in ("sampling", "beam-search"):
        dst = os.path.join(tmp, f"samples-lstm-{kind}")
        t0 = time.perf_counter()
        cli_sample.main(["--model-output", model, "--checkpoint", "-1", "--data", small,
                         "--out-samples", dst, "--sampling-type", kind, "--batch-size", "32",
                         "--max-seq-len", str(L)])
        torch.cuda.synchronize()
        names, notes = parse_midi_dir(dst)
        check(names and len(names) % 3 == 0, f"cli.sample {kind} wrote {len(names)} files")
        log(f"lstm sample path ({kind}): {len(names)} MIDI files parsed back ({notes} note "
            f"events) in {time.perf_counter() - t0:.1f} s")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_evaluate.main(["--model-output", model, "--data", data, "--transfer-stats"])
    vals = json.loads(out.getvalue().strip().splitlines()[-1])
    for k in ("ppl", "acc", "total_loss", "termination_rate", "octave_js_to_target_class"):
        check(k in vals and math.isfinite(vals[k]), f"LSTM cli.evaluate: {k}")
    check(vals["transfer_sequences"] == 2 * 4 * 32, f"LSTM evaluate: {vals}")
    log("lstm evaluate path: cli.evaluate --transfer-stats: " + json.dumps(vals))

    # the step loop's decode at the serving shape: 32 sources x 2 classes, T=130
    vae = load_inference_model(model, -1, torch.device("cuda"))
    b = canonical_batches[0]
    tokens = torch.as_tensor(b.tokens, dtype=torch.long).cuda()
    seq_lens = torch.as_tensor(b.seq_lens, dtype=torch.long).cuda()

    def transfer(seed=5):
        return decode.style_transfer_all_classes(vae, tokens, seq_lens, T, 2, seed)

    seqs, _ = transfer()
    steps = int((seqs != 0).sum(-1).max())
    ms = [time_cuda(transfer, 5), time_cuda(transfer, 5)]
    with torch.inference_mode():
        classes = torch.arange(2, device="cuda").repeat_interleave(tokens.shape[0])
        z = decode._encode_deterministic(vae, tokens.repeat(2, 1), seq_lens.repeat(2), classes)
    decode_ms = [time_cuda(lambda: decode.decode_sampled(vae, z, classes, T, 5), 5)
                 for _ in range(2)]
    log(f"LSTM decode (step loop, bf16, B=64, T={T}, {steps} positions to the last row's "
        f"end): style_transfer_all_classes {ms[0]:.3f} / {ms[1]:.3f} ms, decode_sampled alone "
        f"{decode_ms[0]:.3f} / {decode_ms[1]:.3f} ms (CUDA events, 5 calls each); on {card}")
    c = counters.read()
    check(c["K1"] == 0 and c["K1 plain"] == 0, f"the LSTM path reached K1: {c}")
    log(f"lstm path: K1 launched 0 times; {time.perf_counter() - t_phase:.1f} s")
    return {"transfer_ms": min(ms), "decode_ms": min(decode_ms)}


def core_flops_bytes(key_lens, T: int, hd: int, causal: bool, esize: int, H: int = CORE_H):
    """(unmasked (query, key) pairs x heads, forward bytes, backward bytes) of
    one K2/K3 (or K4/K5) call: each input read once, each output written
    once (forward: q, k, v read, out and lse written; backward: q, k, v,
    out, dO and lse read, dq, dk, dv written)."""
    lens = key_lens.long().clamp(0, T).cpu()
    if causal:  # query q sees min(q + 1, len) keys
        q = torch.arange(T)
        pairs = int(torch.minimum(q[None, :] + 1, lens[:, None]).sum())
    else:
        pairs = int(lens.sum()) * T
    pairs *= H
    B = lens.shape[0]
    qkv = B * T * H * 3 * hd * esize
    ctx = B * T * H * hd * esize
    lse = B * H * T * 4
    return pairs, qkv + ctx + lse + 4 * B, 2 * qkv + 2 * ctx + lse + 4 * B


def bound(flops: float, nbytes: float, dtype: torch.dtype):
    """(bound ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def measure_core(ac, batch) -> dict:
    """K2 and K3 per launch at both wide shapes (bf16, the main path's key
    lengths from a corpus batch, random values), the card held back while
    the host enqueues, beside their bounds, their plain versions and
    scaled_dot_product_attention on the same q, k, v, and the host time of
    a wrapper call."""
    import torch.nn.functional as F

    out = {}
    for name, T, hd, causal in CORE_SHAPES:
        seq_lens = torch.as_tensor(batch.seq_lens).long()
        lens = (seq_lens if name == "encoder" else seq_lens + 1).to(torch.int32).cuda()
        qkv, _, dout = core_inputs(T, hd, torch.bfloat16, seed=1)
        scale = 1.0 / math.sqrt(hd)
        fwd = lambda: ac.core_forward(qkv, lens, CORE_H, causal, scale)  # noqa: E731
        ctx, lse = fwd()
        bwd = lambda: ac.core_backward(qkv, lens, lse, ctx, dout, CORE_H, causal, scale)  # noqa: E731
        k2 = [time_cuda(fwd, 40, queued=True), time_cuda(fwd, 40, queued=True)]
        k3 = [time_cuda(bwd, 40, queued=True), time_cuda(bwd, 40, queued=True)]
        host = []  # us of host time a wrapper call, the card left to run behind
        for fn in (fwd, bwd):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                fn()
            host.append((time.perf_counter() - t0) / 100 * 1e6)
            torch.cuda.synchronize()
        p2 = time_cuda(lambda: ac.core_forward_reference(qkv, lens, CORE_H, causal, scale), 3)
        p3 = time_cuda(lambda: ac.core_backward_reference(qkv, lens, lse, ctx, dout, CORE_H,
                                                          causal, scale), 3)
        q, k, v = (x.contiguous().requires_grad_() for x in ac.head_views(qkv, CORE_H))
        mask = ac._mask(lens, T, causal)  # [B, 1, T, T], True = attend
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)  # noqa: E731
        lib2 = time_cuda(sdpa, 20)
        o = sdpa()
        g = dout.reshape(CORE_B, T, CORE_H, hd).permute(0, 2, 1, 3).contiguous()
        lib3 = time_cuda(lambda: torch.autograd.grad(o, (q, k, v), g, retain_graph=True), 20)
        pairs, fbytes, bbytes = core_flops_bytes(lens, T, hd, causal, 2)
        b2, by2 = bound(4 * hd * pairs, fbytes, torch.bfloat16)
        b3, by3 = bound(10 * hd * pairs, bbytes, torch.bfloat16)
        out[name] = {"K2": (min(k2), p2, lib2, b2, by2), "K3": (min(k3), p3, lib3, b3, by3)}
        log(f"{name} T={T} hd={hd} causal={causal} key_lens={lens.tolist()} bf16 "
            f"({ac.core_route(qkv.dtype, hd)} kernels): {pairs} unmasked pairs; "
            f"K2 {k2[0]:.4f} / {k2[1]:.4f} ms (bound {b2:.4f} ms, {by2}; plain {p2:.3f} ms; "
            f"SDPA {lib2:.4f} ms), K3 {k3[0]:.4f} / {k3[1]:.4f} ms (bound {b3:.4f} ms, {by3}; "
            f"plain {p3:.3f} ms; SDPA backward {lib3:.4f} ms); the wrappers' host time "
            f"{host[0]:.1f} / {host[1]:.1f} us a call")
    return out


def measure_flash(fa, ac, batch) -> dict:
    """K4 and K5 per launch at both long shapes (the main path's key lengths
    from a corpus batch) and at T=8192 (one row, key length 7168, causal and
    not: the lengths at which the JAX dispatch streams K and V), bf16, random
    values, the model's strided layout; beside their bounds, their plain
    versions and scaled_dot_product_attention on the same q, k, v, and the
    host time of a wrapper call."""
    import torch.nn.functional as F

    seq_lens = torch.as_tensor(batch.seq_lens).long()
    shapes = [(name, T, hd, causal, (seq_lens if name == "encoder" else seq_lens + 1).tolist(), 10)
              for name, T, hd, causal in FLASH_SHAPES]
    shapes += [(f"T={FLASH_LONG_T}" + (" causal" if causal else ""), FLASH_LONG_T, 64, causal,
                [FLASH_LONG_T * 7 // 8], 5) for causal in (False, True)]
    out = {}
    for name, T, hd, causal, key_lens, reps in shapes:
        lens = torch.tensor(key_lens, dtype=torch.int32).cuda()
        q, k, v, dout, _ = flash_inputs(len(key_lens), T, hd, torch.bfloat16, seed=1)
        scale = hd ** -0.5
        fwd = lambda: fa.flash_forward(q, k, v, lens, causal, scale)  # noqa: E731
        o, lse = fwd()
        bwd = lambda: fa.flash_backward(q, k, v, lens, lse, o, dout, causal, scale)  # noqa: E731
        k4 = [time_cuda(fwd, 2 * reps, queued=True), time_cuda(fwd, 2 * reps, queued=True)]
        k5 = [time_cuda(bwd, 2 * reps, queued=True), time_cuda(bwd, 2 * reps, queued=True)]
        host = []  # us of host time a wrapper call, the card left to run behind
        for fn in (fwd, bwd):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                fn()
            host.append((time.perf_counter() - t0) / 50 * 1e6)
            torch.cuda.synchronize()
        plain_reps = 3 if T < FLASH_LONG_T else 1  # its [T, T] float32 arrays: once is enough
        p4 = time_cuda(lambda: fa.flash_forward_reference(q, k, v, lens, causal, scale), plain_reps)
        p5 = time_cuda(lambda: fa.flash_backward_reference(q, k, v, lens, lse, o, dout, causal,
                                                           scale), plain_reps)
        qs, ks, vs = (x.contiguous().requires_grad_() for x in (q, k, v))
        mask = ac._mask(lens, T, causal)  # [B, 1, T, T], True = attend
        sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, scale=scale)  # noqa: E731
        lib4 = time_cuda(sdpa, reps)
        o2 = sdpa()
        lib5 = time_cuda(lambda: torch.autograd.grad(o2, (qs, ks, vs), dout, retain_graph=True), reps)
        pairs, fbytes, bbytes = core_flops_bytes(lens, T, hd, causal, 2, FLASH_H)
        b4, by4 = bound(4 * hd * pairs, fbytes, torch.bfloat16)
        b5, by5 = bound(10 * hd * pairs, bbytes, torch.bfloat16)
        out[name] = {"K4": (min(k4), p4, lib4, b4, by4), "K5": (min(k5), p5, lib5, b5, by5)}
        log(f"{name} B={len(key_lens)} H={FLASH_H} T={T} hd={hd} causal={causal} key_lens={key_lens} "
            f"bf16: {pairs} unmasked pairs, {4 * hd * pairs / 1e9:.2f} GFLOP forward, "
            f"{fbytes / 1e6:.1f} MB forward / {bbytes / 1e6:.1f} MB backward; "
            f"K4 {k4[0]:.4f} / {k4[1]:.4f} ms (bound {b4:.4f} ms, {by4}; plain {p4:.3f} ms x"
            f"{plain_reps}; SDPA {lib4:.4f} ms), K5 {k5[0]:.4f} / {k5[1]:.4f} ms (bound {b5:.4f} "
            f"ms, {by5}; plain {p5:.3f} ms x{plain_reps}; SDPA backward {lib5:.4f} ms); the "
            f"wrappers' host time {host[0]:.1f} / {host[1]:.1f} us a call")
        del o2, mask
    return out


def recipe_setup(script: str, extra=(), seed: int = 0, mesh=None):
    """scripts/<script>'s model (seeded weights, on the card), optimizer and
    loss settings, as cli.main builds them: (args, model, optimizer, loss);
    with a ``mesh``, the model sharded onto it and the optimizer's
    collectives over it, as the trainer sets them up."""
    from types import SimpleNamespace

    from musicstyletransfer_torch.cli.flags import build_parser
    from musicstyletransfer_torch.cli.main import create_model_config
    from musicstyletransfer_torch.midi.vocab import NUM_EVENTS
    from musicstyletransfer_torch.models.vae import StyleVAE, init_params
    from musicstyletransfer_torch.training.optimizer import Optimizer, OptimizerConfig
    from musicstyletransfer_torch.training.train_step import LossConfig

    args, _ = build_parser().parse_known_args(
        recipe_argv(script, "-", "-", "-", required=("--max-seq-len", "--batch-size"))
        + list(extra))
    corpus = SimpleNamespace(num_classes=lambda: 2, num_tokens=lambda: NUM_EVENTS)
    model = init_params(StyleVAE(create_model_config(args, corpus)), seed).cuda()
    sync = None
    if mesh is not None:
        from musicstyletransfer_torch.parallel.mesh import FlatSync, shard_model

        sync = FlatSync(mesh, shard_model(model, mesh), mesh.device)
    opt = Optimizer(list(model.parameters()), OptimizerConfig(
        args.optimizer, args.optimizer_params, args.learning_rate),
        accumulate_steps=args.grad_accum_steps, sync=sync)
    loss_cfg = LossConfig(kl_weight=args.kl_loss, kl_anneal_steps=args.kl_anneal_steps,
                          free_bits=args.free_bits)
    return args, model, opt, loss_cfg


def graph_vs_eager(script: str, batches, lengths, extra=(), mesh=None) -> dict:
    """Groups of ``lengths`` steps of the recipe (batches taken in turn)
    from one seeded state: as eager ``step_body`` calls, and as one replay
    a group of CUDA graphs of those lengths held by one ``GraphedSteps``, as
    the trainer runs them (the graph of a shorter group, an epoch's
    remainder, shares the memory pool and replays out of capture order).
    The parameters, the optimizer's state, the step count, the metric sums
    and the generator's state must come out bit for bit the same
    (TOL_GRAPH_REL where a reason is stated there), and the launch counters
    must count each replay's launches as the eager steps' own. K1's weight
    pack, made before the steps, must follow the trained weights (equal to
    a pack made afresh), and K1's forced logits on the trained model agree
    with the plain version's within TOL_LOGITS. With a ``mesh`` every step
    runs its collectives (the gradient's all-reduce), eager and captured in
    the graphs."""
    from musicstyletransfer_torch.ops import counters
    from musicstyletransfer_torch.parallel.mesh import use_mesh
    from musicstyletransfer_torch.ops import fused_decode as fd
    from musicstyletransfer_torch.training.graph import GraphedSteps
    from musicstyletransfer_torch.training.train_step import (TrainState, batch_tensors,
                                                              metric_names, step_body)

    runs = []
    for graphed in (False, True):
        args, model, opt, loss_cfg = recipe_setup(script, extra, mesh=mesh)
        stale = None if model.is_lstm else fd.pack_weights(model)
        state = TrainState(metric_names(model), "cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        tensors = [batch_tensors(b, "cuda") for b in batches]
        counters.reset()
        graphs = GraphedSteps(model, opt, loss_cfg, state, gen, max(lengths)) if graphed else None
        done = 0
        with use_mesh(mesh):
            for n in lengths:
                group = [tensors[(done + i) % len(tensors)] for i in range(n)]
                done += n
                if graphed:
                    graphs.run(group)
                else:
                    for t in group:
                        step_body(model, opt, loss_cfg, state, *t, generator=gen)
        torch.cuda.synchronize()
        runs.append({"params": opt.flat.clone(), **{f"opt.{k}": v.clone()
                                                    for k, v in opt.state.items()},
                     "step": state.step.clone(), "sums": state.sums.clone(),
                     "counts": state.counts.clone(),
                     "generator": gen.get_state().to(torch.int64).cuda(),
                     "launches": counters.read()})
        if model.is_lstm:  # K1 does not take the LSTM decoder
            k1_err = None
            continue
        pack = fd.pack_weights(model)
        model._fused_decode_pack = None
        fresh = fd.pack_weights(model)
        check(pack is not stale and all(torch.equal(pack[k], fresh[k])
                                        for k in ("wt", "wf", "emb", "pos")),
              f"{script}: K1's weight pack did not follow the trained weights")
        model.eval()
        x0, classes = decode_inputs(model, 8, seed=11)
        forced = torch.as_tensor(np.random.default_rng(12).integers(3, 293, (8, 24)),
                                 dtype=torch.int32, device="cuda")
        _, _, kl = fd.fused_decode(model, x0, 24, 0, mode="forced", forced_tokens=forced,
                                   classes=classes)
        _, _, pl = fd.fused_decode_reference(model, x0, 24, 0, mode="forced",
                                             forced_tokens=forced, classes=classes)
        k1_err = float((kl - pl).abs().max())
        check(math.isfinite(k1_err) and k1_err <= TOL_LOGITS[model.compute_dtype],
              f"{script}: K1 on the trained model, forced logits max|err| {k1_err}")
    eager, graph = runs
    check(eager["launches"] == graph["launches"],
          f"{script}: launches eager {eager['launches']} vs graphed {graph['launches']}")
    diffs = {}
    for k, v in eager.items():
        if k == "launches":
            continue
        w = graph[k]
        diffs[k] = 0.0 if torch.equal(v, w) else float(
            ((v.double() - w.double()).abs().max() / v.double().abs().max().clamp(min=1e-30)))
    worst = max(diffs.values())
    check(all(math.isfinite(d) for d in diffs.values()) and worst <= TOL_GRAPH_REL,
          f"{script} graphs of {lengths} vs eager: {diffs}")
    log(f"graph vs eager, {script} {' '.join(extra)}{'' if mesh is None else f' on {mesh}'} "
        f"(B={args.batch_size}, L={args.max_seq_len}"
        f", {args.dtype}), groups of {'+'.join(map(str, lengths))} steps: "
        + ("bit for bit identical" if worst == 0.0 else f"max rel diff {worst:.3g} ({diffs})")
        + f" (parameters, optimizer state, step, metric sums, generator); launches "
        f"{ {k: v for k, v in graph['launches'].items() if v} } in both"
        + ("" if k1_err is None else f"; K1's pack follows the trained weights, forced "
           f"logits max|err| {k1_err:.3g} against the plain version"))
    return diffs


def measure_training(batch, label: str, script: str, kernels: dict, n: int,
                     extra=()) -> dict:
    """ms per training step of a recipe (the CLI's model and optimizer),
    eager and as replays of a CUDA graph of ``n`` steps (the recipe's
    steps per dispatch), target tokens per second, and from torch.profiler
    the kernels' ms a step, the device's busy share, the kernels launched
    and the host ops a step, and the share of each kernel in ``kernels``
    ({id: substrings of its kernels' symbols})."""
    from torch.profiler import ProfilerActivity, profile

    from musicstyletransfer_torch.midi.vocab import PAD_ID
    from musicstyletransfer_torch.training.graph import GraphedSteps
    from musicstyletransfer_torch.training.train_step import (TrainState, batch_tensors,
                                                              metric_names, step_body)

    args, model, opt, loss_cfg = recipe_setup(script, extra)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = TrainState(metric_names(model), "cuda")
    tensors = batch_tensors(batch, "cuda")
    tokens = int((tensors[3] != PAD_ID).sum())
    graphs = GraphedSteps(model, opt, loss_cfg, state, gen, n)
    modes = {"eager": (lambda: step_body(model, opt, loss_cfg, state, *tensors, generator=gen), 1),
             "graphed": (lambda: graphs.run([tensors] * n), n)}

    def dev(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    res = {"tokens": tokens}
    for mode, (fn, steps) in modes.items():
        for _ in range(3):
            fn()
        reps = max(1, 10 // steps)
        ms = [time_cuda(fn, reps) / steps, time_cuda(fn, reps) / steps]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
        done = reps * steps  # steps in the profile
        # Device-side events only: a CPU op (an autograd Function around a
        # ctypes launch, aten::mm) also carries its kernels' time as its own.
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        total = sum(dev(e) for e in events) / 1e3  # ms over the profiled steps
        host = [e for e in prof.key_averages()
                if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA]
        r = {"ms": min(ms), "tokens_per_s": tokens / (min(ms) / 1e3),
             "kernel_ms": total / done, "busy": total / max(prof_wall, 1e-9),
             "launches": sum(e.count for e in events) / done,
             "host_ops": sum(e.count for e in host) / done,
             "shares": {k: sum(dev(e) for e in events if any(sym in e.key for sym in syms))
                        / 1e3 / max(total, 1e-9) for k, syms in kernels.items()}}
        res[mode] = r
        top = sorted(events, key=dev, reverse=True)[:6]
        log(f"{label} training step, {mode}{f' (graphs of {n} steps)' if steps > 1 else ''} "
            f"(B={args.batch_size}, L={args.max_seq_len}, {args.dtype}, {args.optimizer}): "
            f"{ms[0]:.3f} / {ms[1]:.3f} ms a step (CUDA events, {reps * steps} steps each); "
            f"{tokens} target tokens -> {r['tokens_per_s']:.0f} tokens/s; profiler ({done} "
            f"steps, {prof_wall:.1f} ms wall): {r['kernel_ms']:.3f} ms of kernels a step, device "
            f"busy {r['busy']:.3f}, {r['launches']:.0f} kernels and {r['host_ops']:.0f} host ops "
            "a step" + "".join(f", {k} {v:.3f} of the kernel time" for k, v in r["shares"].items()))
        log("  top device time: " + "; ".join(f"{e.key[:60]} {dev(e) / done / 1e3:.3f} ms/step"
                                             for e in top))
    return res


def k1_bound(model, x0, seqs, T_: int):
    """K1's bound for one call from this call's output: the decode steps each
    row ran (up to its EOS) times the flops of a step, the weights read once
    and the outputs written once."""
    from musicstyletransfer_torch.midi.vocab import EOS_ID

    tc = model.decoder.config.transformer_config
    D, NL, V = tc.model_size, tc.num_layers, model.decoder.config.output_dim
    s = seqs.long().cpu()
    eos = (s == EOS_ID).int().argmax(1)
    ended = (s == EOS_ID).any(1)
    last = torch.where(ended, eos, torch.full_like(eos, T_ - 1))  # last position computed
    flops = 0.0
    for n in last.tolist():
        t = np.arange(n + 1)  # positions 0..n, attention over t+1 keys
        flops += float(np.sum(NL * (24 * D * D + 4 * (t + 1) * D) + 2 * D * V))
    pack = model._fused_decode_pack
    esize = x0.element_size()
    nbytes = (pack["wt"].numel() * esize + pack["wf"].numel() * 4 + pack["emb"].numel() * esize
              + T_ * D * pack["pos"].element_size() + x0.numel() * esize + s.numel() * 4
              + s.shape[0] * 4)
    return bound(flops, nbytes, x0.dtype)


def parse_midi_dir(out: str):
    """Parse every MIDI file in ``out`` back to tokens; returns (names,
    note events)."""
    from musicstyletransfer_torch.midi import smf
    from musicstyletransfer_torch.midi.codec import tokenize_track
    from musicstyletransfer_torch.midi.vocab import FEATURE_OFFSET, is_timeshift

    names = sorted(os.listdir(out))
    notes = 0
    for n in names:
        tracks = smf.read_midifile(os.path.join(out, n)).tracks
        toks = np.concatenate([tokenize_track(t) for t in tracks])
        check(bool((toks >= FEATURE_OFFSET).all()), f"{n}: bad token")
        notes += int(sum(not is_timeshift(int(t)) for t in toks))
    return names, notes


def main_path(fd, device):
    """Sampling.process_dataset on the shipped checkpoint, through --gpu."""
    import itertools

    from musicstyletransfer_torch.cli.flags import get_config
    from musicstyletransfer_torch.data import Loader, MelodyDataset
    from musicstyletransfer_torch.inference.sampler import get_sampler
    from musicstyletransfer_torch.utils import resolve_device

    args = get_config(["--gpu", "--batch-size", "32", "--max-seq-len", str(L)])
    check(resolve_device(gpu=args.gpu, cpu=args.cpu) == device, "--gpu did not resolve to CUDA")
    loader = Loader(path=os.path.join(REPO, "work", "data", "guitar_bass"),
                    max_sequence_length=args.max_seq_len)
    dataset = MelodyDataset(args.batch_size, loader.max_sequence_length, loader.melodies)
    sampler = get_sampler("sampling", os.path.join(REPO, "models", "guitar_bass"), -1,
                          args, device)

    class FirstBatches:
        def __init__(self, n):
            self.n = n

        def num_classes(self):
            return dataset.num_classes()

        def __iter__(self):
            return itertools.islice(iter(dataset), self.n)

    with tempfile.TemporaryDirectory() as out:
        fd.fused_decode.launches = 0
        fd.fused_decode_reference.cuda_runs = 0
        sampler.process_dataset(FirstBatches(2), out)
        torch.cuda.synchronize()
        launches = fd.fused_decode.launches
        plain_runs = fd.fused_decode_reference.cuda_runs
        check(launches > 0, "the main path launched the fused decode kernel 0 times")
        check(plain_runs == 0, f"the plain decode loop ran {plain_runs} times on CUDA")
        names, notes = parse_midi_dir(out)
        check(len(names) == 2 * 32 * 3, f"expected 192 MIDI files, got {len(names)}")
        log(f"main path: {len(names)} MIDI files written and parsed back "
            f"({notes} note events); fused_decode launches {launches}, plain "
            f"decode loops on CUDA {plain_runs}")
    return sampler.model, dataset, launches


MODEL = os.path.join(REPO, "models", "guitar_bass")
SERVE_BUCKETS, SERVE_BATCH, SERVE_REQUESTS = (16, 32, 64), 32, 64
SLOTS, SEGMENT = 128, 32  # the engine's defaults (cli.serve --streaming)


def corpus_requests(n: int):
    """n MIDI requests: the corpus's L=64 chunks, each written as a MIDI file."""
    from musicstyletransfer_torch.data import Loader, MelodyDataset
    from musicstyletransfer_torch.midi import smf
    from musicstyletransfer_torch.midi.codec import MelodyWriter, melody_from_ids

    writer, out = MelodyWriter(), []
    loader = Loader(os.path.join(REPO, "work", "data", "guitar_bass"), L)
    for batch in MelodyDataset(32, L, loader.melodies):
        for row in batch.tokens[:batch.num_valid]:
            out.append(smf.dump_midifile(writer.to_midifile(melody_from_ids(row))))
            if len(out) == n:
                return out
    raise AssertionError(f"the corpus holds fewer than {n} chunks of {L}")


def midi_tokens(midi: bytes):
    """The note-event tokens of a MIDI byte string; every token a real event."""
    from musicstyletransfer_torch.midi import smf
    from musicstyletransfer_torch.midi.codec import tokenize_track
    from musicstyletransfer_torch.midi.vocab import FEATURE_OFFSET

    tracks = smf.parse_midifile(midi).tracks
    toks = np.concatenate([tokenize_track(t) for t in tracks] or [np.zeros(0, np.int32)])
    check(bool((toks >= FEATURE_OFFSET).all()), "a result holds a token that is no event")
    return toks


def wait_all(events, timeout: float, what: str) -> None:
    deadline = time.perf_counter() + timeout
    for ev in events:
        check(ev.wait(max(0.0, deadline - time.perf_counter())), f"{what}: timed out")


def closed_loop(svc, requests, clients: int, seconds: float):
    """``clients`` threads, each enqueueing its next request as soon as the
    last one is served, for ``seconds``: (requests/s, latencies in ms)."""
    import threading

    lat, errors, lock = [], [], threading.Lock()
    stop_at = time.perf_counter() + seconds

    def client(i):
        k = i
        while time.perf_counter() < stop_at and not errors:
            ev, box = threading.Event(), []
            t0 = time.perf_counter()
            svc.enqueue(requests[k % len(requests)], lambda r: (box.append(r), ev.set()))
            if not ev.wait(60) or isinstance(box[0], Exception):
                errors.append(box[0] if box else "timed out")
                return
            with lock:
                lat.append((time.perf_counter() - t0) * 1e3)
            k += clients

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=seconds + 120)
    wall = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in threads), f"closed loop: {errors[:1]}")
    return len(lat) / wall, sorted(lat)


def open_loop(eng, requests, rate: float, seconds: float):
    """Requests enqueued at ``rate`` a second for ``seconds`` (evenly
    spaced), whatever the engine's progress: (served/s, latencies in ms)."""
    import threading

    n = max(1, int(rate * seconds))
    events, lat, got = [threading.Event() for _ in range(n)], [0.0] * n, [None] * n
    t_start = time.perf_counter()
    for i in range(n):
        delay = t_start + i / rate - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        t0 = time.perf_counter()

        def cb(r, i=i, t0=t0):
            lat[i] = (time.perf_counter() - t0) * 1e3
            got[i] = r
            events[i].set()

        eng.enqueue(requests[i % len(requests)], cb)
    wait_all(events, 120, "open loop")
    wall = time.perf_counter() - t_start
    bad = [r for r in got if isinstance(r, Exception)]
    check(not bad, f"open loop: {bad[:1]}")
    return n / wall, sorted(lat)


def pct(sorted_ms, p: float) -> float:
    from musicstyletransfer_torch.inference.service import _percentile

    return _percentile(sorted_ms, p)


def drive_cycles(eng, schedule, requests):
    """Cycles of ``eng`` by hand: cycle i admits ``schedule[i]`` requests
    (the next ones of ``requests``), nothing is harvested; returns every
    state tensor and the readout after each cycle, on the host."""
    snaps, k = [], 0
    eng._ensure_state()
    for n in schedule:
        eng._cycle_idx += 1
        arrivals = [(eng._tokens_from_midi(m), lambda r: None, 0.0) for m in requests[k:k + n]]
        k += n
        eng._dispatch(eng._register(arrivals) if arrivals else None)
        torch.cuda.synchronize()
        snaps.append([x.cpu() for x in eng._state.tensors() + [eng._readout]])
    return snaps


def engine_rows(eng, requests):
    """Every request through ``eng`` (its loop driven inline): the raw token
    row of each (request, class)."""
    import threading

    eng._result_of = lambda req: dict(req.results_tokens)
    out, events = {}, [threading.Event() for _ in requests]
    for i, midi in enumerate(requests):
        eng.enqueue(midi, lambda r, i=i: (out.__setitem__(i, r), events[i].set()))
    deadline = time.perf_counter() + 120
    while not all(e.is_set() for e in events) and time.perf_counter() < deadline:
        eng._cycle(block=False)
    check(all(e.is_set() for e in events), "engine rows: timed out")
    return out


def engine_vs_k1(requests, dtype: torch.dtype, decode):
    """Greedy tokens of the engine (graphed cycles) against K1's greedy
    decode of the same requests: the share of identical (request, class)
    rows up to each request's budget."""
    import dataclasses

    from musicstyletransfer_torch.inference.streaming import StreamingTransferEngine
    from musicstyletransfer_torch.midi.vocab import PAD_ID, SOS_ID
    from musicstyletransfer_torch.models import StyleVAE

    eng = StreamingTransferEngine(MODEL, -1, slots=SLOTS, segment_steps=SEGMENT, greedy=True)
    if dtype == torch.float32:
        model = StyleVAE(dataclasses.replace(eng.model.config, dtype="float32"))
        model.load_state_dict(eng.model.state_dict())
        eng.model = model.to(eng.device).eval()
    rows = engine_rows(eng, requests)
    toks = [eng._tokens_from_midi(m) for m in requests]
    tokens = np.full((len(toks), L + 1), PAD_ID, np.int64)
    tokens[:, 0] = SOS_ID
    for i, t in enumerate(toks):
        tokens[i, 1:len(t) + 1] = t
    dev = eng.device
    lens = torch.as_tensor([len(t) + 1 for t in toks], device=dev)
    C = eng.num_classes
    classes = torch.arange(C, device=dev).repeat_interleave(len(toks))
    seqs, _ = decode.sample_sequences(eng.model, torch.as_tensor(tokens, device=dev).repeat(C, 1),
                                      lens.repeat(C), classes, eng.t_gen, 0, greedy=True)
    seqs = seqs.cpu().numpy().reshape(C, len(toks), -1)
    same = [np.array_equal(rows[i][c][:2 * (len(t) + 1)], seqs[c, i, :2 * (len(t) + 1)])
            for i, t in enumerate(toks) for c in range(C)]
    return float(np.mean(same)), len(same)


def read_lines(proc, out) -> None:
    for line in proc.stdout:
        out.append(line)


def serve_http_clis(requests):
    """``python -m musicstyletransfer_torch.cli.serve --http 0`` on loopback,
    plain and --streaming, both started at once: concurrent posts (JSON
    and raw), /stats and /healthz. Every process is stopped at the end."""
    import base64
    import signal
    import threading
    import urllib.request

    procs, lines = {}, {}
    try:
        for label, extra in (("plain", []), ("streaming", ["--streaming"])):
            p = subprocess.Popen(
                [sys.executable, "-m", "musicstyletransfer_torch.cli.serve", "--model-output",
                 MODEL, "--http", "0", "--max-seq-len", str(L), "--buckets", "16,32,64", *extra],
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs[label], lines[label] = p, []
            threading.Thread(target=read_lines, args=(p, lines[label]), daemon=True).start()
        deadline = time.perf_counter() + 240
        urls = {}
        while len(urls) < len(procs) and time.perf_counter() < deadline:
            for label, p in procs.items():
                check(p.poll() is None, f"cli.serve {label} exited: {''.join(lines[label])[-2000:]}")
                m = next((re.search(r"serving HTTP on ([\d.]+):(\d+)", x) for x in lines[label]
                          if "serving HTTP" in x), None)
                if m:
                    urls[label] = f"http://{m.group(1)}:{m.group(2)}"
            time.sleep(0.1)
        check(len(urls) == len(procs), f"cli.serve did not come up: {lines}")
        for label, url in urls.items():
            errors, n = [], 16

            def post(i, url=url, errors=errors):
                try:
                    raw = i % 2 == 1
                    req = urllib.request.Request(url + ("/transfer?class=1" if raw else "/transfer"),
                                                 data=requests[i], method="POST")
                    with urllib.request.urlopen(req, timeout=120) as resp:
                        body = resp.read()
                    if raw:
                        midi_tokens(body)
                    else:
                        for v in json.loads(body).values():
                            midi_tokens(base64.b64decode(v))
                except Exception as exc:  # surfaced below
                    errors.append(exc)

            t0 = time.perf_counter()
            threads = [threading.Thread(target=post, args=(i,)) for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=150)
            wall = time.perf_counter() - t0
            check(not errors and not any(t.is_alive() for t in threads),
                  f"cli.serve {label}: {errors[:1]}")
            with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
                check(resp.read() == b"ok", f"cli.serve {label}: /healthz")
            with urllib.request.urlopen(url + "/stats", timeout=30) as resp:
                stats = json.loads(resp.read())
            check(stats["requests_served"] >= n, f"cli.serve {label}: /stats {stats}")
            log(f"cli.serve --http {label}: {n} concurrent posts (JSON and ?class=1) answered "
                f"and parsed in {wall:.2f} s; /healthz ok; /stats served "
                f"{stats['requests_served']} in {stats['batches']} batches/harvests, p50 "
                f"{stats['latency_p50_ms']:.1f} ms, p99 {stats['latency_p99_ms']:.1f} ms")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        for p in procs.values():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)


def serving_path(fd, decode, card: str) -> dict:
    """The serving entry points on the shipped model (bf16) on CUDA.

    1. StyleTransferService (buckets 16,32,64, batch 32): 64 corpus
       requests through the threaded loop, each result parsed back; K1
       launched once a micro-batch, its plain loop never. Then closed-loop
       requests/s and p50/p99 (64 clients, 3 s).
    2. StreamingTransferEngine (128 slots, 32 steps a cycle): graphed cycles
       equal eager cycles bit for bit (sampled, admissions between cycles);
       open-loop p50/p99 at half the service's capacity for 5 s; ms a cycle
       graphed and eager, host ops a cycle, the readout copy's ms.
    3. Engine greedy against K1 greedy: float32 token for token; bf16 the
       share of identical rows, printed.
    4. cli.serve --http, plain and --streaming, through their processes.
    Returns the K1 launches of step 1 and the numbers."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    from musicstyletransfer_torch.inference import StreamingTransferEngine, StyleTransferService
    from musicstyletransfer_torch.ops import counters

    t_phase = time.perf_counter()
    requests = corpus_requests(SERVE_REQUESTS)
    svc = StyleTransferService(MODEL, -1, batch_size=SERVE_BATCH, max_seq_len=L,
                               buckets=list(SERVE_BUCKETS))
    svc.start()  # warms up: the weight pack, the libraries' handles
    counts(reset=True)
    try:
        got = [None] * len(requests)
        events = [threading.Event() for _ in requests]
        for i, midi in enumerate(requests):
            svc.enqueue(midi, lambda r, i=i: (got.__setitem__(i, r), events[i].set()))
        wait_all(events, 120, "service")
        c = counts()
        snap = svc.stats.snapshot()
        for r in got:
            check(not isinstance(r, Exception), f"service: {r}")
            check(set(r.midi_by_class) == {0, 1}, "service: a class is missing")
            for midi in r.midi_by_class.values():
                midi_tokens(midi)
        launches = c["K1"]
        check(launches == snap["batches"] >= len(requests) // SERVE_BATCH,
              f"service: {launches} K1 launches for {snap['batches']} micro-batches")
        check(c["K1 plain"] == 0, f"service: the plain decode loop ran {c['K1 plain']} times")
        log(f"service path: {len(requests)} corpus requests x 2 classes through the threaded "
            f"loop in {snap['batches']} micro-batches (buckets {SERVE_BUCKETS}); every result "
            f"parsed back; K1 launches {launches}, plain decode loops on CUDA {c['K1 plain']}")
        saved = counters.read()
        svc.stats = type(svc.stats)()
        rps, lat = closed_loop(svc, requests, clients=64, seconds=3.0)
        counters.write(saved)  # timing launches are not the main path's
    finally:
        svc.stop()
    svc_p50, svc_p99 = pct(lat, 50), pct(lat, 99)
    log(f"service closed loop (64 clients, 3 s, batch {SERVE_BATCH}, bf16): {rps:.1f} "
        f"requests/s, p50 {svc_p50:.2f} ms, p99 {svc_p99:.2f} ms, mean fill "
        f"{svc.stats.snapshot()['mean_batch_fill']:.1f} [{card}]")

    # Graphed cycles against eager cycles from one seed, sampled.
    schedule = (3, 0, 5, 0, 4, 0)
    engines = [StreamingTransferEngine(MODEL, -1, slots=SLOTS, segment_steps=SEGMENT, seed=3)
               for _ in range(2)]
    engines[1].use_graphs = False
    a, b = (drive_cycles(e, schedule, requests) for e in engines)
    for i, (sa, sb) in enumerate(zip(a, b)):
        for x, y in zip(sa, sb):
            check(torch.equal(x, y), f"engine cycle {i + 1}: the graph differs from eager")
    check(engines[0].graph_replays == len(schedule) and engines[1].graph_replays == 0,
          "engine: the graphed engine did not replay its graphs")
    log(f"engine graph vs eager: {len(schedule)} cycles (admissions {schedule}, sampled), "
        f"every state tensor and readout bit for bit")

    # ms a cycle, graphed and eager: all slots live (one admission fills them).
    cycle_ms, host_ops = {}, {}
    for mode, eng in (("graphed", engines[0]), ("eager", engines[1])):
        eng._dispatch(eng._register(
            [(eng._tokens_from_midi(m), lambda r: None, 0.0)
             for m in requests[:len(eng._free_slots) // 2]]))
        n = 20

        def cycles(eng=eng, n=n):
            for _ in range(n):
                eng._dispatch(None)

        cycles()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(eng._stream)
        cycles()
        end.record(eng._stream)
        end.synchronize()
        cycle_ms[mode] = start.elapsed_time(end) / n
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            cycles(n=5)
            torch.cuda.synchronize()
        host_ops[mode] = sum(e.count for e in prof.key_averages()
                             if e.device_type != torch.autograd.DeviceType.CUDA) / 5
    eng = engines[0]
    copies = []
    for _ in range(20):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(eng._stream), torch.inference_mode():
            e0.record()
            eng._ring[0].copy_(eng._readout, non_blocking=True)
            e1.record()
        e1.synchronize()
        copies.append(e0.elapsed_time(e1))
    copy_ms = statistics.median(copies)
    log(f"engine cycle ({SLOTS} slots x {SEGMENT} steps, bf16, all slots live): graphed "
        f"{cycle_ms['graphed']:.3f} ms, eager {cycle_ms['eager']:.3f} ms; host ops a cycle "
        f"{host_ops['graphed']:.0f} graphed, {host_ops['eager']:.0f} eager; readout copy "
        f"[{SLOTS}, {1 + engines[0].t_gen}] int16 to pinned memory {copy_ms:.4f} ms "
        f"(median of 20, event to event) [{card}]")

    # Open loop at half the service's measured capacity.
    eng = StreamingTransferEngine(MODEL, -1, slots=SLOTS, segment_steps=SEGMENT)
    eng.start()
    try:
        eng_rps, eng_lat = open_loop(eng, requests, 0.5 * rps, 5.0)
    finally:
        eng.stop()
    snap = eng.stats.snapshot()
    log(f"engine open loop at {0.5 * rps:.1f} requests/s (half the service's capacity, 5 s): "
        f"served {eng_rps:.1f}/s, p50 {pct(eng_lat, 50):.2f} ms, p99 {pct(eng_lat, 99):.2f} ms; "
        f"{eng.cycles_dispatched} cycles ({eng.graph_replays} graph replays), ring waits "
        f"{eng.ring_waits}, mean slot fill {snap['mean_batch_fill']:.1f} [{card}]")
    check(eng.graph_replays == eng.cycles_dispatched > 0, "engine: a cycle ran eagerly")

    saved = counters.read()
    same32, n32 = engine_vs_k1(requests, torch.float32, decode)
    check(same32 == 1.0, f"engine vs K1 greedy, float32: only {same32:.4f} of rows identical")
    same16, n16 = engine_vs_k1(requests, torch.bfloat16, decode)
    counters.write(saved)
    log(f"engine greedy vs K1 greedy ({n32} rows): float32 token for token; bf16 "
        f"{same16:.4f} of rows identical (not gated)")

    serve_http_clis(requests)
    log(f"serving phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "rps": rps, "p50": svc_p50, "p99": svc_p99,
            "engine_p50": pct(eng_lat, 50), "engine_p99": pct(eng_lat, 99),
            "cycle_ms": cycle_ms, "host_ops": host_ops, "copy_ms": copy_ms,
            "bf16_same": same16}


RING_NS = (2, 4)  # ring sizes run in lock step on the one card


def ring_path(fa, enc_lens) -> dict:
    """Ring attention (ops/ring_attention.py) at train-vae-long.sh's widths:
    the encoder (H=8, hd=64, T=2047, padded to the ring) and the decoder
    (hd=32, T=2048, causal), B=4, bf16, the corpus batch's key lengths with
    the last row cut to 300 keys (inside the first chunk: every later chunk
    of that row has 0 visible keys). For n = 2 and 4 the ring's ranks run
    in lock step on the card through the package's step code (the rotation
    by list index); out, lse and dq/dk/dv are held against K4/K5 on the
    whole T, and the ring's K4/K5 launches counted (n x n a direction, all on
    the tensor-core kernels). Timed against the whole-T kernels."""
    from musicstyletransfer_torch.ops import ring_attention as ra
    from musicstyletransfer_torch.parallel.mesh import SeqShard

    enc = [int(n) for n in enc_lens][:LONG_B - 1] + [300]
    out = {"launches": {"K4": 0, "K5": 0}, "err": {"K4": 0.0, "K5": 0.0}, "lines": []}
    dt = torch.bfloat16
    for name, T, hd, causal in FLASH_SHAPES:
        lens = enc if name == "encoder" else [n + 1 for n in enc]
        q, k, v, dout, _ = flash_inputs(LONG_B, T, hd, dt, seed=T + hd + 1)
        key_lens = torch.tensor(lens, dtype=torch.int32).cuda()
        scale = hd ** -0.5
        whole_out, whole_lse = fa.flash_forward(q, k, v, key_lens, causal, scale)
        whole_grads = fa.flash_backward(q, k, v, key_lens, whole_lse, whole_out, dout, causal,
                                        scale)
        live = whole_lse > -1e29
        for n in RING_NS:
            chunks = [[SeqShard(T, n, r).local(x, 2).contiguous() for r in range(n)]
                      for x in (q, k, v, dout)]
            tag = f"{name} T={T} hd={hd} causal={causal} n={n}"
            before = counts()
            fwd = ra.ring_forward_lockstep(*chunks[:3], key_lens, causal, scale)
            outs, lses = [o for o, _ in fwd], [l for _, l in fwd]
            bwd = ra.ring_backward_lockstep(*chunks[:3], key_lens, outs, lses, chunks[3],
                                            causal, scale)
            torch.cuda.synchronize()
            after = counts()
            moved = {kk: after[kk] - before[kk] for kk in ("K4", "K4 tc", "K5", "K5 tc")}
            check(moved == {"K4": n * n, "K4 tc": n * n, "K5": n * n, "K5 tc": n * n},
                  f"ring {tag}: launches {moved}, expected {n * n} a direction on the "
                  "tensor-core kernels")
            for kk in ("K4", "K5"):
                out["launches"][kk] += n * n
            ring_out = torch.cat(outs, 2)[:, :, :T]
            ring_lse = torch.cat(lses, 2)[:, :, :T]
            check(bool(torch.isfinite(ring_out).all() and torch.isfinite(ring_lse).all()),
                  f"ring {tag}: non-finite out or lse")
            out_err = float((ring_out - whole_out.float()).abs().max())
            lse_err = float((ring_lse - whole_lse)[live].abs().max())
            check(bool(torch.equal(ring_lse <= -1e29, ~live)), f"ring {tag}: no-key rows differ")
            check(out_err <= TOL_CTX[dt], f"ring {tag}: out max|err| {out_err} > {TOL_CTX[dt]}")
            check(lse_err <= TOL_LSE[dt], f"ring {tag}: lse max|err| {lse_err} > {TOL_LSE[dt]}")
            rels = []
            for j, gname in enumerate("qkv"):
                d = torch.cat([b[j] for b in bwd], 2)[:, :, :T]
                check(bool(torch.isfinite(d).all()), f"ring {tag}: non-finite d{gname}")
                err = float((d - whole_grads[j].float()).abs().max())
                rels.append(err / max(float(whole_grads[j].float().abs().max()), 1e-30))
                out["err"]["K5"] = max(out["err"]["K5"], err)
            check(max(rels) <= TOL_DQKV_REL[dt], f"ring {tag}: rel errs {rels}")
            out["err"]["K4"] = max(out["err"]["K4"], out_err)
            saved = counts()
            ms = {
                "ring fwd": time_cuda(lambda: ra.ring_forward_lockstep(
                    *chunks[:3], key_lens, causal, scale), 5),
                "whole K4": time_cuda(lambda: fa.flash_forward(q, k, v, key_lens, causal,
                                                               scale), 5),
                "ring bwd": time_cuda(lambda: ra.ring_backward_lockstep(
                    *chunks[:3], key_lens, outs, lses, chunks[3], causal, scale), 5),
                "whole K5": time_cuda(lambda: fa.flash_backward(
                    q, k, v, key_lens, whole_lse, whole_out, dout, causal, scale), 5),
            }
            from musicstyletransfer_torch.ops import counters

            counters.write(saved)  # timing launches are not the path's
            out[tag] = ms
            line = (f"ring {tag}, key_lens={lens}: out max|err| {out_err:.3g} (tol "
                    f"{TOL_CTX[dt]}), lse {lse_err:.3g} (tol {TOL_LSE[dt]}), dq/dk/dv rel "
                    f"{max(rels):.3g} (tol {TOL_DQKV_REL[dt]}) against K4/K5 on the whole T; "
                    f"{n * n} K4 + {n * n} K5 launches; ms: ring forward (n ranks in lock "
                    f"step) {ms['ring fwd']:.4f} vs whole-T K4 {ms['whole K4']:.4f}, ring "
                    f"backward {ms['ring bwd']:.4f} vs whole-T K5 {ms['whole K5']:.4f}")
            log(line)
    return out


# pipeline_path: (stages, microbatches) of each stack, and the tolerances
# (output, gradients) of the pipelined stack against two references, in
# float32 and in bfloat16 (the recipes' dtype): "whole", the sequential
# stack on the whole batch, and "microbatched", the sequential stack on each
# microbatch in turn (the same products at the same shapes as the pipeline's
# stages). The output's error is its max|err| relative to its largest
# |value|; a parameter's gradient error the norm of its error relative to
# its norm (floored at 1e-3 of the largest gradient norm of the stack: the
# key bias's gradient is float32 noise, softmax ignoring a shared shift).
# Against the whole batch the microbatch is a GEMM of another M, for which
# cuBLAS may pick another algorithm, and where a ReLU's input is ~0 a
# rounding then flips it: that entry of a weight's gradient differs by one
# token's whole term (on an H100 at the wide stack in float32: 1.3e-2 of a
# weight's max|entry|, 1.0e-3 of a bias's norm), hence the norms and the
# looser whole-batch tolerances. Against the microbatched stack the output
# is held bit for bit; the gradients differ by the order in which the
# microbatches' terms are summed.
PIPE_CUTS = {"wide": ((4, 4), (2, 4)), "long": ((2, 2),)}
TOL_PIPE = {("whole", torch.float32): (1e-5, 1e-2), ("whole", torch.bfloat16): (1e-2, 2e-2),
            ("microbatched", torch.float32): (0.0, 1e-5),
            ("microbatched", torch.bfloat16): (0.0, 1e-5)}


def pipeline_stack(script: str, batch, dtype: str):
    """The encoder stack of scripts/<script>'s model (seeded weights, on the
    card, compute in ``dtype``), its input (token + class embeddings, before
    scaling) and key mask for ``batch``, and a seeded float32 cotangent."""
    from musicstyletransfer_torch.midi.vocab import PAD_ID

    _, model, _, _ = recipe_setup(script, extra=("--dtype", dtype))
    enc = model.encoder
    dt = enc.compute_dtype
    tokens = torch.as_tensor(batch.tokens, dtype=torch.long, device="cuda")
    classes = torch.as_tensor(batch.classes, dtype=torch.long, device="cuda")
    with torch.no_grad():
        x = enc.token_emb(tokens).to(dt) + enc.class_emb(classes).to(dt)[:, None, :]
    g = torch.Generator(device="cuda").manual_seed(11)
    cot = torch.randn(x.shape, generator=g, device="cuda")
    return enc.encoder.eval(), x, tokens != PAD_ID, cot


def stack_grads(stack, fn, cot):
    """(output, {name: gradient}) of sum(fn().float() * cot) over the stack's
    parameters."""
    names, params = zip(*stack.named_parameters())
    out = fn()
    grads = torch.autograd.grad((out.float() * cot).sum(), params)
    return out.detach(), dict(zip(names, grads))


def grad_rel_errs(grads, ref_grads) -> dict:
    """{name: |grad - ref| / max(|ref|, 1e-3 of the largest |ref| of all)}
    in the Frobenius norm: the parameters' gradient errors as TOL_PIPE
    holds them."""
    norms = {n: float(g.float().norm()) for n, g in ref_grads.items()}
    floor = 1e-3 * max(norms.values())
    return {n: float((grads[n].float() - g.float()).norm()) / max(norms[n], floor, 1e-30)
            for n, g in ref_grads.items()}


def pipeline_path(card: str, wide_batch, long_batch) -> dict:
    """Pipeline parallelism (parallel/pipeline.py, transformer_pipeline.py)
    on the one card, its stages in lock step in this process
    (pipeline_transformer_stack with mesh=None): the wide recipe's encoder
    stack at full width (train-vae-wide.sh: 4 x 1024, 16 heads, hd 64,
    pre-LN, the attention core: K2/K3) on the corpus's L=512 batch (B=8,
    T=513) as pp=4 x 1 layer and pp=2 x 2 layers, 4 microbatches each; the
    long recipe's (train-vae-long.sh: 4 x 512, 8 heads, post-LN, flash:
    K4/K5) on its L=2046 batch (B=4, T=2047) as pp=2, 2 microbatches. The
    output and every parameter's gradient of sum(out * cotangent) equal the
    sequential TransformerStack's on the whole batch and on each microbatch
    in turn, within TOL_PIPE, in float32 and in bfloat16; each stage's
    layers launch their kernels once a microbatch
    (bf16: on the tensor cores). The bf16 runs' launches are the path's;
    pipelined and sequential forward + backward timed (CUDA events)."""
    from musicstyletransfer_torch.ops import counters
    from musicstyletransfer_torch.parallel import pipeline_transformer_stack

    res = {"launches": {k: 0 for k in ("K2", "K3", "K4", "K5")}, "ms": {}, "err": {}}
    for label, script, batch in (("wide", "train-vae-wide.sh", wide_batch),
                                 ("long", "train-vae-long.sh", long_batch)):
        kernels = ("K2", "K3") if label == "wide" else ("K4", "K5")
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            stack, x, mask, cot = pipeline_stack(script, batch, dtype)
            n_layers = len(stack.layers)
            ref_out, ref_grads = stack_grads(stack, lambda: stack(x, mask), cot)
            torch.cuda.synchronize()
            for S, M in PIPE_CUTS[label]:
                tag = (f"{label} {n_layers} x {stack.config.model_size}, B={x.shape[0]}, "
                       f"T={x.shape[1]}, {dtype}, pp={S} x {n_layers // S} layers, {M} "
                       "microbatches")
                counts(reset=True)
                out, grads = stack_grads(stack, lambda: pipeline_transformer_stack(
                    stack, x, mask, mesh=None, microbatches=M, n_stages=S), cot)
                torch.cuda.synchronize()
                c = counts()
                want = n_layers * M
                for k in kernels:
                    check(c[k] == want, f"pipeline {tag}: {k} launched {c[k]} times, "
                          f"expected {n_layers} layers x {M} microbatches")
                    if dt == torch.bfloat16:
                        check(c[f"{k} tc"] == want, f"pipeline {tag}: {k} off the tensor cores")
                        res["launches"][k] += c[k]
                check(all(c[k] == 0 for k in counters.PLAIN),
                      f"pipeline {tag}: a plain version ran on the card: {c}")
                check(bool(torch.isfinite(out.float()).all()), f"pipeline {tag}: non-finite")
                mb_out, mb_grads = stack_grads(stack, lambda: torch.cat(
                    [stack(xm, km) for xm, km in zip(x.chunk(M), mask.chunk(M))]), cot)
                errs = []
                for ref, (r_out, r_grads) in (("whole", (ref_out, ref_grads)),
                                              ("microbatched", (mb_out, mb_grads))):
                    out_err = float((out.float() - r_out.float()).abs().max()) / max(
                        float(r_out.float().abs().max()), 1e-30)
                    grad_errs = grad_rel_errs(grads, r_grads)
                    worst = max(grad_errs, key=grad_errs.get)
                    out_tol, grad_tol = TOL_PIPE[(ref, dt)]
                    errs.append(f"{ref}: output {out_err:.3g} (tol {out_tol}), gradients "
                                f"{grad_errs[worst]:.3g} (tol {grad_tol}; {worst})")
                    check(out_err <= out_tol, f"pipeline {tag}: against the {ref} stack, "
                          f"output rel err {out_err} > {out_tol}")
                    check(grad_errs[worst] <= grad_tol, f"pipeline {tag}: against the {ref} "
                          f"stack, gradient rel err {grad_errs[worst]} > {grad_tol} ({worst})")
                    res["err"][(tag, ref)] = (out_err, grad_errs[worst])
                same = torch.equal(out, mb_out)
                if dt == torch.bfloat16:
                    saved = counts()
                    runs = {"pipelined": lambda: stack_grads(
                        stack, lambda: pipeline_transformer_stack(
                            stack, x, mask, mesh=None, microbatches=M, n_stages=S), cot),
                            "sequential": lambda: stack_grads(stack, lambda: stack(x, mask), cot)}
                    ms = {k: time_cuda(fn, 5) for k, fn in runs.items()}
                    prof = {k: profiled(fn) for k, fn in runs.items()}
                    counters.write(saved)  # timing launches are not the path's
                    res["ms"][tag] = (ms["pipelined"], ms["sequential"])
                    timing = "; forward + backward " + ", ".join(
                        f"{k} {ms[k]:.3f} ms (profiler, one call: {prof[k][0]:.3f} ms of "
                        f"kernels in {prof[k][1]:.3f} ms, busy {prof[k][0] / prof[k][1]:.3f}, "
                        f"{prof[k][2]} kernels, {prof[k][3]} host ops)" for k in runs) + (
                        f" (the {S} stages in lock step on one card), on {card}")
                else:
                    timing = ""
                log(f"pipeline {tag}: rel errs against the sequential stack, "
                    f"{'; '.join(errs)}; output bit for bit the microbatched stack's: {same}; "
                    f"{' '.join(f'{k} {c[k]}' for k in kernels)} launches{timing}")
            del stack, x, mask, cot, ref_out, ref_grads
    counts(reset=True)
    return res


def dist_path(tmp: str, batches, card: str) -> dict:
    """Multi-process training's entry point on the one card, a world of one
    rank on NCCL: cli.main with scripts/train-distributed.sh's flags (B=32,
    L=64, encoder 2x256/8 heads, latent 256, decoder 1x128, Adam with
    clip_gradient 1.0, bf16) in groups of 8 steps for one epoch, once with
    --dist-coordinator 127.0.0.1:<free port> --dist-num-processes 1
    --dist-process-id 0 and once without: both end with the same
    parameters and optimizer state bit for bit. In this process, a world of
    one on NCCL: CUDA graphs of 8 and 3 steps with the gradient's
    all-reduce captured against the same eager steps, bit for bit; the
    graphed step's ms with and without the mesh; the all-reduce's ms on the
    flat gradient (CUDA events)."""
    import torch.distributed as dist

    from musicstyletransfer_torch.parallel import initialize_distributed, make_mesh, use_mesh
    from musicstyletransfer_torch.training import checkpoint as ckpt
    from musicstyletransfer_torch.training.graph import GraphedSteps
    from musicstyletransfer_torch.training.train_step import TrainState, batch_tensors, metric_names

    data = os.path.join(REPO, "work", "data", "guitar_bass")
    folders = {}
    for label, extra in (("dist", ["--dist-coordinator", f"127.0.0.1:{free_port()}",
                                   "--dist-num-processes", "1", "--dist-process-id", "0"]),
                         ("single", [])):
        folder = os.path.join(tmp, f"distributed-{label}")
        argv = recipe_argv("train-distributed.sh", data, folder, os.path.join(tmp, "out-dist"),
                           required=("--batch-size", "--max-seq-len"))
        t0 = time.perf_counter()
        stdout = run_cli("main", argv + extra + [
            "--steps-per-dispatch", "8", "--epochs", "1", "--checkpoint-frequency", "100000",
            "--logdir", folder + "-log", "--log-every", "8"])
        folders[label] = folder
        check_train_log(train_lines(os.path.join(folder + "-log", "scalars.jsonl")),
                        f"train-distributed.sh {label}", guarded=False)
        log(f"dist path: cli.main train-distributed.sh ({label}) one epoch in "
            f"{time.perf_counter() - t0:.1f} s" + (
                ": " + next(x for x in stdout.splitlines() if "Mesh(" in x)
                if label == "dist" else ""))
    a, b = (ckpt.restore_checkpoint(folders[k], 1) for k in ("dist", "single"))
    check(a["step"] == b["step"] > 0, f"dist path: steps {a['step']} vs {b['step']}")
    check(torch.equal(a["params"], b["params"]), "dist path: parameters differ from the "
          "run without --dist-*")
    for k, v in b["optimizer"].items():
        check(torch.equal(a["optimizer"][k], v), f"dist path: optimizer {k} differs")
    log(f"dist path: world-1 NCCL run and the run without --dist-*: {a['step']} steps, "
        "parameters and optimizer state bit for bit identical")

    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, torch.device("cuda", 0))
    try:
        mesh = make_mesh(1, torch.device("cuda", 0))
        graph_vs_eager("train-distributed.sh", batches, (8, 3), mesh=mesh)
        res = {}
        tensors = batch_tensors(batches[0], "cuda")
        for label, m in (("no mesh", None), ("world-1 mesh", mesh)):
            args, model, opt, loss_cfg = recipe_setup("train-distributed.sh", mesh=m)
            state = TrainState(metric_names(model), "cuda")
            gen = torch.Generator(device="cuda").manual_seed(0)
            graphs = GraphedSteps(model, opt, loss_cfg, state, gen, 8)
            with use_mesh(m):
                for _ in range(2):
                    graphs.run([tensors] * 8)
                res[label] = min(time_cuda(lambda: graphs.run([tensors] * 8), 3) / 8
                                 for _ in range(2))
        flat = torch.randn(opt.flat.numel(), device="cuda")
        res["all_reduce"] = time_cuda(lambda: mesh.all_reduce_data_mean_(flat), 20)
        log(f"dist path timings ({card}): graphed step (groups of 8, B=32, L=64, bf16) "
            f"{res['no mesh']:.4f} ms without a mesh, {res['world-1 mesh']:.4f} ms on the "
            f"world-1 NCCL mesh; the flat gradient's all-reduce ({flat.numel():,} float32) "
            f"{res['all_reduce']:.4f} ms (CUDA events, mean of 20)")
    finally:
        dist.destroy_process_group()
    return res


def multi_gpu_path(tmp: str) -> None:
    """Two-process NCCL training, only where the host has 2 cards: DP=2
    against one process on the global batch, tp=2 against tp=1 (both
    train-distributed.sh's model in float32: the first step's loss within
    1e-4), and --ring-attention --tp 2 at train-vae-long.sh's L=2046 (its
    first step's loss within 2e-2 of one process, finite throughout). Not
    run on one card, where NCCL refuses two ranks on one device."""
    import socket

    if torch.cuda.device_count() < 2:
        log("multi_gpu_path: not run (1 card)")
        return
    data = os.path.join(REPO, "work", "data", "guitar_bass")

    def run(label, script, extra, world, required):
        folder = os.path.join(tmp, f"multi-{label}")
        argv = recipe_argv(script, data, folder, os.path.join(tmp, "out-multi"),
                           required=required)
        argv += ["--epochs", "1", "--checkpoint-frequency", "100000", "--logdir",
                 folder + "-log", "--log-every", "1", *extra]
        cmd = [sys.executable, "-m", "musicstyletransfer_torch.cli.main", *argv]
        if world == 1:
            procs = [subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)]
        else:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            procs = [subprocess.Popen(cmd + ["--dist-coordinator", f"127.0.0.1:{port}",
                                             "--dist-num-processes", str(world),
                                             "--dist-process-id", str(r)],
                                      cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for r in range(world)]
        texts = []
        for p in procs:
            text, _ = p.communicate(timeout=900)
            check(p.returncode == 0, f"multi_gpu_path {label}: exited {p.returncode}:\n"
                  f"{text[-3000:]}")
            texts.append(text)
        lines = train_lines(os.path.join(folder + "-log", "scalars.jsonl"))
        check_train_log(lines, f"multi_gpu_path {label}", guarded=script != "train-distributed.sh")
        # the primary's log: updates/s since the start, and over each window
        # between two log lines (one step each, its host read included)
        total = re.findall(r"updates/sec: ([0-9.]+)", texts[0])
        windows = [float(x) for x in re.findall(r"\(window: ([0-9.]+)\)", texts[0])]
        log(f"multi_gpu_path {label}: {world} process(es), {len(lines)} scalar lines; "
            f"updates/s {total[-1] if total else 'not logged'} since the start, median "
            f"window {statistics.median(windows) if windows else 'not logged'} over "
            f"{len(windows)} (logging every step)")
        return next(x for x in lines if "ce_loss" in x)["ce_loss"]

    small = ("--batch-size", "--max-seq-len")
    f32 = ["--dtype", "float32"]
    one = run("one", "train-distributed.sh", f32, 1, small)
    for label, extra in (("dp2", f32), ("tp2", f32 + ["--tp", "2"])):
        got = run(label, "train-distributed.sh", extra, 2, small)
        check(abs(got - one) <= 1e-4 * abs(one), f"multi_gpu_path {label}: first ce_loss {got} "
              f"vs {one} on one process")
        log(f"multi_gpu_path {label}: first ce_loss {got:.6f} vs {one:.6f} on one process")
    long_one = run("long-one", "train-vae-long.sh", [], 1, small)
    ring = run("long-ring2", "train-vae-long.sh", ["--tp", "2"], 2, small)
    check(abs(ring - long_one) <= 2e-2 * abs(long_one),
          f"multi_gpu_path ring: first ce_loss {ring} vs {long_one}")
    log(f"multi_gpu_path --ring-attention --tp 2 at L={LONG_L}: first ce_loss {ring:.6f} vs "
        f"{long_one:.6f} on one process")
    multi_gpu_inference(tmp)
    multi_gpu_pipeline(tmp)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def nccl_world1():
    """A world of one rank on NCCL in this process, and its (1, 1) mesh,
    laid out without a device (``make_mesh`` follows the backend)."""
    import torch.distributed as dist

    from musicstyletransfer_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, torch.device("cuda", 0))
    try:
        mesh = make_mesh(1)
        check(mesh.device == torch.device("cuda", 0), f"make_mesh on NCCL: {mesh.device}")
        yield mesh
    finally:
        dist.destroy_process_group()


def sharded_path(fd, decode, card: str) -> dict:
    """Sharded inference on the shipped model (bf16) over a world-1 NCCL
    mesh, 32 corpus sources x 2 classes, L=64, max_len 130, greedy:

    1. sharded_style_transfer_all_classes equals style_transfer_all_classes
       token for token and score for score, with one K1 launch (one a data
       shard) and no plain loop; a sampled sharded call launches K1 once
       too and gives finite scores;
    2. the split of rows into shards on the card: K1 greedy on each half of
       the 64 rows equals the whole batch's launch token for token;
    3. StyleTransferService(mesh=) and StreamingTransferEngine(mesh=) at
       greedy equal mesh=None on 16 corpus requests; the service's
       micro-batch is one K1 launch;
    4. CUDA-event ms of the sharded call against the unsharded call, and of
       the rows' all-gather.
    Returns the K1 launches of 1 and 3 (the phase's main path) and the
    numbers."""
    from musicstyletransfer_torch.data import Loader, MelodyDataset
    from musicstyletransfer_torch.inference import (StreamingTransferEngine, StyleTransferService,
                                                    sharded_style_transfer_all_classes)
    from musicstyletransfer_torch.inference.sampler import load_inference_model
    from musicstyletransfer_torch.inference.sharded import gather_rows

    t_phase = time.perf_counter()
    cuda = torch.device("cuda")
    batch = next(iter(MelodyDataset(32, L, Loader(os.path.join(REPO, "work", "data",
                                                               "guitar_bass"), L).melodies)))
    tokens = torch.as_tensor(batch.tokens, dtype=torch.long, device=cuda)
    seq_lens = torch.as_tensor(batch.seq_lens, dtype=torch.long, device=cuda)
    model = load_inference_model(MODEL, -1, cuda)
    requests = corpus_requests(16)
    res = {"launches": 0}
    with nccl_world1() as mesh:
        def sharded(greedy=True, seed=0):
            return sharded_style_transfer_all_classes(
                model, tokens, seq_lens, T, 2, torch.Generator().manual_seed(seed), mesh,
                greedy=greedy, params_on_mesh=True)

        want, want_scores = decode.style_transfer_all_classes(model, tokens, seq_lens, T, 2, 0,
                                                              greedy=True)
        counts(reset=True)
        got, got_scores = sharded()
        sampled, sampled_scores = sharded(greedy=False)
        torch.cuda.synchronize()
        c = counts()
        check(c["K1"] == 2 and c["K1 plain"] == 0,
              f"sharded calls: {c['K1']} K1 launches (expected 2), {c['K1 plain']} plain loops")
        res["launches"] += c["K1"]
        check(torch.equal(got, want) and torch.equal(got_scores, want_scores),
              "sharded greedy transfer differs from the unsharded one")
        check(bool(torch.isfinite(sampled_scores).all()) and sampled.shape == want.shape,
              "sharded sampled transfer: non-finite scores or a wrong shape")
        log(f"sharded path: sharded_style_transfer_all_classes on a world-1 NCCL mesh "
            f"({mesh}), 32x2 rows, T={T}, bf16: greedy equal to the unsharded call token for "
            f"token and score for score; one K1 launch a call (a data shard), no plain loop")

        with torch.inference_mode():
            classes = torch.arange(2, device=cuda).repeat_interleave(32)
            z = decode._encode_deterministic(model, tokens.repeat(2, 1), seq_lens.repeat(2),
                                             classes)
            x0 = model.decode_init(z, classes).contiguous()
        launches = fd.fused_decode.launches
        whole, _ = fd.fused_decode(model, x0, T, 0, mode="greedy")
        halves = [fd.fused_decode(model, x0[h:h + 32].contiguous(), T, 0, mode="greedy")[0]
                  for h in (0, 32)]
        fd.fused_decode.launches = launches  # checks, not the main path
        same = torch.equal(torch.cat(halves), whole)
        rows_same = int((torch.cat(halves) == whole).all(-1).sum())
        check(same, f"K1 on each half of the rows differs from the whole batch's launch: "
              f"{rows_same} of 64 rows equal")
        log(f"sharded path: K1 greedy on rows 0-31 and 32-63 (plan "
            f"{fd.plan_for(model, 32, T)}) equals the launch on all 64 (plan "
            f"{fd.plan_for(model, 64, T)}) token for token")

        svc = {label: StyleTransferService(MODEL, -1, batch_size=16, max_seq_len=L,
                                           greedy=True, mesh=m)
               for label, m in (("plain", None), ("mesh", mesh))}
        toks = [svc["plain"]._tokens_from_midi(m) for m in requests]
        plain = svc["plain"].transfer_tokens(toks)
        counts(reset=True)
        meshed = svc["mesh"].transfer_tokens(toks)
        torch.cuda.synchronize()
        c = counts()
        svc["mesh"].stop()  # the stop header (to this one rank)
        check(c["K1"] == 1, f"sharded service micro-batch: {c['K1']} K1 launches")
        res["launches"] += c["K1"]
        for i, (a, b) in enumerate(zip(plain, meshed)):
            for cls in a.tokens_by_class:
                check(np.array_equal(a.tokens_by_class[cls], b.tokens_by_class[cls]),
                      f"service(mesh=) request {i} class {cls} differs from mesh=None")
        engines = [StreamingTransferEngine(MODEL, -1, slots=SLOTS, segment_steps=SEGMENT,
                                           greedy=True, mesh=m) for m in (None, mesh)]
        rows = [engine_rows(e, requests) for e in engines]
        engines[1].stop()
        for i in rows[0]:
            for cls in rows[0][i]:
                check(np.array_equal(rows[0][i][cls], rows[1][i][cls]),
                      f"engine(mesh=) request {i} class {cls} differs from mesh=None")
        log(f"sharded path: StyleTransferService(mesh=) (one K1 launch a micro-batch) and "
            f"StreamingTransferEngine(mesh=) ({SLOTS} slots, graph replays "
            f"{engines[1].graph_replays}) equal mesh=None on {len(requests)} corpus "
            f"requests, greedy, token for token")

        saved = counts()
        res["unsharded_ms"] = time_cuda(
            lambda: decode.style_transfer_all_classes(model, tokens, seq_lens, T, 2, 0,
                                                      greedy=True), 20)
        res["sharded_ms"] = time_cuda(sharded, 20)
        res["unsharded_ms2"] = time_cuda(
            lambda: decode.style_transfer_all_classes(model, tokens, seq_lens, T, 2, 0,
                                                      greedy=True), 20)
        res["sharded_ms2"] = time_cuda(sharded, 20)
        local = got.reshape(64, T)
        res["gather_ms"] = time_cuda(lambda: gather_rows(local, mesh), 50)
        from musicstyletransfer_torch.ops import counters
        counters.write(saved)  # timing launches are not the main path's
    log(f"sharded path timings ({card}): style_transfer_all_classes 32x2 rows, T={T}, bf16, "
        f"greedy, CUDA events, mean of 20: unsharded {res['unsharded_ms']:.4f} / "
        f"{res['unsharded_ms2']:.4f} ms, sharded on the world-1 mesh {res['sharded_ms']:.4f} / "
        f"{res['sharded_ms2']:.4f} ms; the rows' all-gather ([64, {T}] int32) "
        f"{res['gather_ms']:.4f} ms (mean of 50); phase {time.perf_counter() - t_phase:.1f} s")
    return res


def gan_dp(batches, card: str) -> dict:
    """GAN data parallelism over a world-1 NCCL mesh at train-gan.sh's model
    (bf16, r1_gamma 0.1): two groups (10 D, 2 G updates) eager and as
    CUDA-graph replays with the gradients' all-reduce captured, bit for bit,
    and both equal to the graphed run without a mesh; updates/s of graphed
    groups of 5 with and without the mesh (CUDA events)."""
    from musicstyletransfer_torch.training.gan_trainer import (GraphedGANGroups, batch_tensors,
                                                               group_pattern)

    t_phase = time.perf_counter()
    res = {}
    with nccl_world1() as mesh:
        runs = {"eager mesh": gan_groups(0.1, False, batches, mesh),
                "graphed mesh": gan_groups(0.1, True, batches, mesh),
                "graphed": gan_groups(0.1, True, batches)}
        for key in ("graphed mesh", "graphed"):
            same = [torch.equal(a, b) for a, b in zip(runs["eager mesh"], runs[key])]
            check(all(same), f"GAN DP: {key} differs from eager steps on the mesh: {same}")
        log("GAN DP (train-gan.sh, bf16, r1_gamma 0.1, world-1 NCCL mesh): 2 groups (10 D, 2 G "
            "updates) with the D and G gradients' all-reduce captured in the graphs equal the "
            "eager steps on the mesh and the graphed steps without it, bit for bit")
        batch = batch_tensors(batches[0], "cuda")
        pattern = group_pattern(0, GAN_K, GAN_K)
        for label, m in (("no mesh", None), ("world-1 mesh", mesh), ("no mesh 2", None),
                         ("world-1 mesh 2", mesh)):
            _, steps = gan_setup(0.1, mesh=m)
            graphs = GraphedGANGroups(steps, GAN_K)
            ms = time_cuda(lambda: graphs.run([batch] * GAN_K, pattern), 10)
            res[label] = GAN_K / (ms / 1e3)
    log(f"GAN DP timings ({card}): graphed groups of {GAN_K} (r1_gamma 0.1, CUDA events, 10 "
        f"groups): {res['no mesh']:.2f} / {res['no mesh 2']:.2f} updates/s without a mesh, "
        f"{res['world-1 mesh']:.2f} / {res['world-1 mesh 2']:.2f} on the world-1 NCCL mesh; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    return res


def examples_path(tmp: str) -> None:
    """The port's two examples as processes on the card:
    examples/torch_style_transfer.py (one corpus file into both classes)
    and examples/torch_gan_generation.py for one epoch (its samples and the
    shipped generator's); every MIDI file they write parses back."""
    t0 = time.perf_counter()
    corpus = os.path.join(REPO, "work", "data", "guitar_bass")
    first = sorted(glob.glob(os.path.join(corpus, "*", "*.mid")))[0]
    runs = (("torch_style_transfer.py", [first, MODEL, os.path.join(tmp, "ex-transfer")],
             [os.path.join(tmp, "ex-transfer")]),
            ("torch_gan_generation.py", [corpus, os.path.join(tmp, "ex-gan"), "1"],
             [os.path.join(tmp, "ex-gan", d) for d in ("samples", "shipped")]))
    for script, argv, outs in runs:
        proc = subprocess.run([sys.executable, os.path.join(REPO, "examples", script), *argv],
                              cwd=REPO, capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"{script} exited {proc.returncode}:\n"
              f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        for out in outs:
            names, notes = parse_midi_dir(out)
            check(len(names) >= 2 and notes > 0, f"{script}: {len(names)} files, {notes} notes "
                  f"in {out}")
        log(f"examples: {script} {' '.join(argv[-1:])}: " + "; ".join(
            f"{len(parse_midi_dir(o)[0])} MIDI files in {os.path.basename(o)} parsed back"
            for o in outs))
    log(f"examples: {time.perf_counter() - t0:.1f} s")


def multi_rank(kind: str, rank: int, world: int, port: int, out: str) -> None:
    """One rank of multi_gpu_path's sharded-inference, GAN and pipeline runs
    (a process of its own, card ``rank``): ``sharded`` writes the sharded
    greedy transfer of sharded_path's batch, ``gan`` the metric means after
    the first D step and after the first group of train-gan.sh's model in
    float32 with GANSteps(mesh=) on its rows, ``pipeline`` the wide stack's
    output and gradients pipelined over the model axis (multi_pipeline)."""
    import torch.distributed as dist

    from musicstyletransfer_torch.data import Loader, MelodyDataset
    from musicstyletransfer_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed(f"127.0.0.1:{port}", world, rank, torch.device("cuda"))
    try:
        if kind == "pipeline":
            result = multi_pipeline(make_mesh(world))
        else:
            mesh = make_mesh(1)
            batches = list(MelodyDataset(32, L, Loader(os.path.join(REPO, "work", "data",
                                                                    "guitar_bass"), L).melodies))
            result = (multi_sharded(batches[0], mesh) if kind == "sharded"
                      else multi_gan(batches, mesh))
        if rank == 0:
            np.savez(out, **result)
    finally:
        dist.destroy_process_group()


def multi_sharded(batch, mesh) -> dict:
    """The sharded (``mesh``) or unsharded greedy transfer of ``batch`` into
    both classes on the shipped model."""
    from musicstyletransfer_torch.inference import decode, sharded_style_transfer_all_classes
    from musicstyletransfer_torch.inference.sampler import load_inference_model

    dev = torch.device("cuda") if mesh is None else mesh.device
    model = load_inference_model(MODEL, -1, dev)
    tokens = torch.as_tensor(batch.tokens, dtype=torch.long, device=dev)
    seq_lens = torch.as_tensor(batch.seq_lens, dtype=torch.long, device=dev)
    if mesh is None:
        seqs, scores = decode.style_transfer_all_classes(model, tokens, seq_lens, T, 2, 0,
                                                         greedy=True)
    else:
        seqs, scores = sharded_style_transfer_all_classes(model, tokens, seq_lens, T, 2,
                                                          torch.Generator(), mesh, greedy=True)
    return {"seqs": seqs.cpu().numpy(), "scores": scores.float().cpu().numpy()}


def multi_gan(batches, mesh) -> dict:
    """train-gan.sh's model in float32 (r1_gamma 0.1), on ``mesh`` each rank
    its rows of each global batch: the metric means after the first D step
    and after the first group (5 D, 1 G updates), eager."""
    from musicstyletransfer_torch.parallel import shard_batch
    from musicstyletransfer_torch.training.gan_trainer import batch_tensors, group_pattern

    _, steps = gan_setup(0.1, mesh=mesh, dtype="float32")
    tensors = [batch_tensors(b, "cuda") for b in batches[:GAN_K]]
    if mesh is not None:
        tensors = [shard_batch(t, mesh) for t in tensors]
    steps.d_step(*tensors[0])
    first = steps.metrics()
    steps.reset_metrics()
    steps.run_group(tensors, group_pattern(0, GAN_K, GAN_K))
    group = steps.metrics()
    out = {f"first/{k}": np.asarray(v) for k, v in first.items()}
    out.update({f"group/{k}": np.asarray(v) for k, v in group.items()})
    return out


def wide_batch_512():
    from musicstyletransfer_torch.data import Loader, MelodyDataset

    corpus = os.path.join(REPO, "work", "data", "guitar_bass")
    return next(iter(MelodyDataset(8, 512, Loader(corpus, 512).melodies)))


def multi_pipeline(mesh) -> dict:
    """The wide recipe's encoder stack (bf16) on the L=512 batch, pipelined
    over ``mesh``'s model axis (one stage a card, 4 microbatches, real P2P
    hops), or sequential without a mesh: the output and the gradients of
    sum(out * cotangent), the stage parameters' summed over the model group
    (each rank holds its own stage's)."""
    from musicstyletransfer_torch.parallel import pipeline_transformer_stack

    stack, x, mask, cot = pipeline_stack("train-vae-wide.sh", wide_batch_512(), "bfloat16")
    if mesh is None:
        out, grads = stack_grads(stack, lambda: stack(x, mask), cot)
    else:
        out, grads = stack_grads(stack, lambda: pipeline_transformer_stack(
            stack, x, mask, mesh=mesh, microbatches=4), cot)
        for name, g in grads.items():
            if name.startswith("layers."):
                grads[name] = mesh.all_reduce_model_sum_(g.clone())
    result = {"out": out.float().cpu().numpy()}
    result.update({f"grad/{n}": g.float().cpu().numpy() for n, g in grads.items()})
    return result


def multi_gpu_pipeline(tmp: str) -> None:
    """multi_gpu_path's pipeline half: a 2-process NCCL
    pipeline_transformer_stack of the wide stack equals this process's
    sequential stack (output and gradients within TOL_PIPE's whole-batch
    bf16 tolerances);
    then ``python -m musicstyletransfer_torch.dryrun --processes
    min(cards, 4)`` passes, every leg's OK line printed."""
    one = multi_pipeline(None)
    out = os.path.join(tmp, "multi-pipeline.npz")
    port = free_port()
    t0 = time.perf_counter()
    logs = [open(os.path.join(tmp, f"pipeline-rank{r}.log"), "w+") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", "import chip_smoke; chip_smoke."
                               f"multi_rank('pipeline', {r}, 2, {port}, {out!r})"],
                              cwd=REPO, stdout=logs[r], stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    deadline = time.time() + 300  # a failed rank leaves the other waiting in a collective
    while any(p.poll() is None for p in procs) and time.time() < deadline and all(
            p.returncode in (None, 0) for p in procs):
        time.sleep(0.5)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    for r, (p, f) in enumerate(zip(procs, logs)):
        f.seek(0)
        text = f.read()
        f.close()
        check(p.returncode == 0, f"multi_gpu_path pipeline: rank {r} exited {p.returncode}:"
              f"\n{text[-3000:]}")
    with np.load(out) as z:
        got = {k: z[k] for k in z.files}
    check(set(got) == set(one), f"multi_gpu_path pipeline: keys {sorted(got)}")
    errs = grad_rel_errs({k: torch.as_tensor(v) for k, v in got.items() if k != "out"},
                         {k: torch.as_tensor(v) for k, v in one.items() if k != "out"})
    errs["out"] = float(np.abs(got["out"] - one["out"]).max()) / max(
        float(np.abs(one["out"]).max()), 1e-30)
    out_tol, tol = TOL_PIPE[("whole", torch.bfloat16)]
    check(errs["out"] <= out_tol, f"multi_gpu_path pipeline: output rel err {errs['out']}")
    worst = max((k for k in errs if k != "out"), key=errs.get)
    check(errs[worst] <= tol, f"multi_gpu_path pipeline: {worst} rel err {errs[worst]} > {tol}")
    log(f"multi_gpu_path pipeline: wide stack (4 x 1024, B=8, T=513, bf16) as 2 NCCL stages "
        f"of 2 layers, 4 microbatches, equals one process's sequential stack: output rel err "
        f"{errs['out']:.3g}, worst gradient rel err {errs[worst]:.3g} ({worst}; tol {tol}); "
        f"{time.perf_counter() - t0:.1f} s")
    n = min(torch.cuda.device_count(), 4)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "musicstyletransfer_torch.dryrun",
                          "--processes", str(n)], cwd=REPO, capture_output=True, text=True,
                         timeout=360)
    lines = [x for x in res.stdout.splitlines() if x.startswith("dryrun")]
    check(res.returncode == 0 and lines and lines[-1].startswith(f"dryrun_multichip({n}) OK"),
          f"the dry run over {n} cards failed ({res.returncode}):\n{res.stdout[-3000:]}\n"
          f"{res.stderr[-3000:]}")
    for line in lines:
        log(f"multi_gpu_path {line}")
    log(f"multi_gpu_path: the dry run over {n} NCCL processes, {len(lines) - 1} legs OK in "
        f"{time.perf_counter() - t0:.1f} s")


def multi_gpu_inference(tmp: str) -> None:
    """multi_gpu_path's inference and GAN halves on 2 cards: a 2-process
    sharded greedy transfer equals one process's token for token (scores
    within 1e-3), and 2-process GAN DP equals one process's first means
    (1e-4 relative, as the 2-process training checks above)."""
    from musicstyletransfer_torch.data import Loader, MelodyDataset

    batches = list(MelodyDataset(32, L, Loader(os.path.join(REPO, "work", "data",
                                                            "guitar_bass"), L).melodies))
    one = {"sharded": multi_sharded(batches[0], None), "gan": multi_gan(batches, None)}
    for kind in ("sharded", "gan"):
        out = os.path.join(tmp, f"multi-{kind}.npz")
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", f"import chip_smoke; chip_smoke."
                                   f"multi_rank({kind!r}, {r}, 2, {port}, {out!r})"],
                                  cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for r in range(2)]
        for p in procs:
            text, _ = p.communicate(timeout=600)
            check(p.returncode == 0, f"multi_gpu_path {kind}: exited {p.returncode}:\n"
                  f"{text[-3000:]}")
        with np.load(out) as z:
            got = {k: z[k] for k in z.files}
        want = one[kind]
        check(set(got) == set(want), f"multi_gpu_path {kind}: keys {sorted(got)}")
        if kind == "sharded":
            check(np.array_equal(got["seqs"], want["seqs"]),
                  "multi_gpu_path: the 2-process sharded transfer differs from one process's")
            check(np.allclose(got["scores"], want["scores"], atol=1e-3),
                  "multi_gpu_path: sharded scores differ")
        else:
            for k, v in want.items():
                check(abs(float(got[k]) - float(v)) <= 1e-4 * abs(float(v)),
                      f"multi_gpu_path GAN DP=2 {k}: {float(got[k])} vs {float(v)}")
        log(f"multi_gpu_path {kind}: 2 processes equal one process "
            f"({time.perf_counter() - t0:.1f} s)" + (
                "" if kind == "sharded" else ": " + ", ".join(
                    f"{k} {float(got[k]):.6f}/{float(v):.6f}" for k, v in sorted(want.items()))))


def time_cuda(fn, n: int, queued: bool = False) -> float:
    """Mean ms per call over n calls, CUDA events, after one warm-up call.
    ``queued`` holds the card back (a spin kernel of ~10 ms) while the host
    enqueues the calls, so that a kernel shorter than its wrapper's host time
    is timed by the card's pace and not by the host's."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def measure(model, dataset, fd, decode):
    """The card's own numbers on the shipped model (bf16)."""
    from musicstyletransfer_torch.midi import smf
    from musicstyletransfer_torch.midi.codec import EventBasedMIDIReader, MelodyWriter, melody_from_ids
    from musicstyletransfer_torch.midi.vocab import PAD_ID, SOS_ID

    batch = next(iter(dataset))
    tokens = torch.as_tensor(batch.tokens, dtype=torch.long).cuda()
    seq_lens = torch.as_tensor(batch.seq_lens, dtype=torch.long).cuda()
    encoded = 2 * int((batch.tokens != PAD_ID).sum())

    def plain_transfer(seed):
        with torch.inference_mode():
            classes = torch.arange(2, device="cuda").repeat_interleave(tokens.shape[0])
            z = decode._encode_deterministic(model, tokens.repeat(2, 1), seq_lens.repeat(2), classes)
            x0 = model.decode_init(z, classes).contiguous()
            return fd.fused_decode_reference(model, x0, T, seed)

    def kernel_transfer(seed):
        return decode.style_transfer_all_classes(model, tokens, seq_lens, T, 2, seed)

    runs = {kernel_transfer: ([], [0]), plain_transfer: ([], [0])}  # ms per call, events

    def timed(fn, n):
        ms, events = runs[fn]
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seqs, _ = fn(i)
            events[0] += encoded + int((seqs[..., 1:] != PAD_ID).sum())  # waits for the device
            ms.append((time.perf_counter() - t0) * 1e3)

    kernel_transfer(0), plain_transfer(0)  # warm-up
    for fn in (plain_transfer, kernel_transfer, kernel_transfer, plain_transfer):
        timed(fn, 10)  # 20 calls a route, in interleaved halves
    (k_ms, k_ev), (p_ms, p_ev) = runs[kernel_transfer], runs[plain_transfer]
    k_eps, p_eps = k_ev[0] / (sum(k_ms) / 1e3), p_ev[0] / (sum(p_ms) / 1e3)
    log(f"style_transfer_all_classes 32x2 rows, T={T}, bf16, 20 calls a route: kernel "
        f"p50 {statistics.median(k_ms):.3f} ms, {k_eps:.0f} note-events/s; plain loop "
        f"p50 {statistics.median(p_ms):.3f} ms, {p_eps:.0f} note-events/s")

    # K1 alone against the plain loop on the same conditioning states.
    with torch.inference_mode():
        classes = torch.arange(2, device="cuda").repeat_interleave(tokens.shape[0])
        z = decode._encode_deterministic(model, tokens.repeat(2, 1), seq_lens.repeat(2), classes)
        x0 = model.decode_init(z, classes).contiguous()
    launches = fd.fused_decode.launches
    plain_ms = time_cuda(lambda: fd.fused_decode_reference(model, x0, T, 5), 5)
    ms = time_cuda(lambda: fd.fused_decode(model, x0, T, 5), 50)
    ms2 = time_cuda(lambda: fd.fused_decode(model, x0, T, 5), 50)
    plain_ms2 = time_cuda(lambda: fd.fused_decode_reference(model, x0, T, 5), 5)
    seqs, _ = fd.fused_decode(model, x0, T, 5)
    bound_ms, bound_by = k1_bound(model, x0, seqs, T)
    fd.fused_decode.launches = launches  # timing launches are not the main path's
    log(f"K1 fused_decode B={x0.shape[0]} T={T} bf16 sample: {ms:.4f} / {ms2:.4f} ms "
        f"(bound {bound_ms:.5f} ms, {bound_by}; plan {fd.plan_for(model, x0.shape[0], T)}); "
        f"plain loop {plain_ms:.3f} / {plain_ms2:.3f} ms")

    # p50 MIDI -> MIDI latency: one file, both classes, through the kernel.
    files = sorted(glob.glob(os.path.join(REPO, "work", "data", "guitar_bass", "*", "*.mid")))
    reader, writer = EventBasedMIDIReader(), MelodyWriter()

    def transfer_one(path, seed):
        melody = reader.read_file(path)[0]
        chunk = melody.tokens[:L]
        src = np.full((1, L + 1), PAD_ID, np.int64)
        src[0, 0] = SOS_ID
        src[0, 1:len(chunk) + 1] = chunk
        seqs, _ = decode.style_transfer_all_classes(
            model, torch.as_tensor(src).cuda(),
            torch.as_tensor([len(chunk) + 1]).cuda(), T, 2, seed)
        return [smf.dump_midifile(writer.to_midifile(melody_from_ids(
            row, bpm=melody.bpm, resolution=melody.resolution)))
            for row in seqs[:, 0].cpu().numpy()]

    transfer_one(files[0], 0)
    lat = []
    for i in range(20):
        t0 = time.perf_counter()
        transfer_one(files[i % len(files)], i)
        lat.append((time.perf_counter() - t0) * 1e3)
    p50 = statistics.median(lat)
    log(f"p50 MIDI->MIDI latency (1 file x 2 classes, kernel): {p50:.3f} ms over 20 calls")
    return {"ms": ms, "plain_ms": plain_ms, "events_per_s": k_eps,
            "plain_events_per_s": p_eps, "p50_ms": p50, "bound_ms": bound_ms,
            "bound_by": bound_by}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    from musicstyletransfer_torch.data import Loader, MelodyDataset
    from musicstyletransfer_torch.inference import decode
    from musicstyletransfer_torch.ops import _build
    from musicstyletransfer_torch.ops import attention_core as ac
    from musicstyletransfer_torch.ops import flash_attention as fa
    from musicstyletransfer_torch.ops import fused_decode as fd

    t0 = time.perf_counter()
    sources = ("fused_decode", "attention_core", "flash_attention", "flash_attention_tc")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        list(pool.map(_build.build, sources))
    for name in sources:
        _build.load(name)
    log(f"build: {', '.join(sources)} compiled and loaded in {time.perf_counter() - t0:.1f} s")

    err32 = check_kernel(torch.float32, fd, decode)
    err16 = check_kernel(torch.bfloat16, fd, decode)
    from musicstyletransfer_torch.models import TransformerConfig

    wide_dec = TransformerConfig(model_size=512, num_layers=2, num_heads=16, norm_scheme="pre")
    long_dec = TransformerConfig(model_size=256, num_layers=2, num_heads=8)
    k1_errs = [err32, err16] + [check_lifted(fd, decode, dt)
                                for dt in (torch.float32, torch.bfloat16)]
    for dt in (torch.float32, torch.bfloat16):
        k1_errs.append(check_decoder(fd, dt, "wide", wide_dec, 1024, 1026))
        k1_errs.append(check_decoder(fd, dt, "long", long_dec, 512, 2 * (LONG_L + 1),
                                     "per_step", reps=1))
    core_err = check_core(ac)
    corpus = os.path.join(REPO, "work", "data", "guitar_bass")
    from musicstyletransfer_torch.midi.native import NativeMIDIReader

    long_loader = Loader(corpus, LONG_L)  # the corpus reads go through the C++ tokenizer
    check(isinstance(long_loader.midi_reader, NativeMIDIReader),
          f"the Loader reads with {type(long_loader.midi_reader).__name__}")
    long_batch = next(iter(MelodyDataset(LONG_B, LONG_L, long_loader.melodies)))
    flash_err = check_flash(fa, long_batch.seq_lens)

    wide_batch = next(iter(MelodyDataset(8, 512, Loader(corpus, 512).melodies)))
    corpus_batches = list(MelodyDataset(32, L, Loader(corpus, L).melodies))
    canonical_batches = corpus_batches[:8]
    graph_vs_eager("train-vae.sh", canonical_batches, (8, 3, 8))  # a group, a remainder, a group
    graph_vs_eager("train-vae.sh", canonical_batches, (2, 2), extra=("--remat",))
    graph_vs_eager("train-vae-wide.sh", [wide_batch], (4, 4))
    graph_vs_eager("train-vae-long.sh", [long_batch], (1, 1))

    counts(reset=True)
    model, dataset, launches = main_path(fd, device)
    serving = serving_path(fd, decode, card)
    sharded = sharded_path(fd, decode, card)
    with tempfile.TemporaryDirectory() as tmp:
        train_counts = train_path(ac, fd, tmp)
        long_counts = long_path(tmp)
        canonical_path(tmp)
        lstm = lstm_path(tmp, canonical_batches, card)
        gan = gan_path(tmp, corpus_batches[:2 * GAN_K], card)
        gan_dp_rates = gan_dp(corpus_batches[:2 * GAN_K], card)
        examples_path(tmp)
        ring = ring_path(fa, long_batch.seq_lens)
        pipe = pipeline_path(card, wide_batch, long_batch)
        dist_ms = dist_path(tmp, canonical_batches, card)
        multi_gpu_path(tmp)

    numbers = measure(model, dataset, fd, decode)
    core = measure_core(ac, wide_batch)
    steps = {"canonical": measure_training(canonical_batches[0], "canonical", "train-vae.sh",
                                           {}, 8),
             "wide": measure_training(wide_batch, "wide", "train-vae-wide.sh",
                                      {"K2": ("core_fwd_kernel_tc",),
                                       "K3": ("core_bwd_dq_kernel_tc",
                                              "core_bwd_dkdv_kernel_tc")}, 4)}
    flash = measure_flash(fa, ac, long_batch)
    steps["long"] = measure_training(long_batch, "long", "train-vae-long.sh",
                                     {"K4": ("flash_fwd_kernel_tc",), "K5": ("flash_bwd_",)}, 1)
    steps["lstm-vae"] = measure_training(canonical_batches[0], "lstm-vae", "train-vae.sh", {}, 8,
                                         extra=("--decoder-type", "lstm"))
    log(f"timings above on: {card}")

    enc = core["encoder"]
    kernels = [{
        "name": "fused_decode", "route": "cuda",
        "source": "musicstyletransfer_torch/ops/csrc/fused_decode.cu",
        "replaces": "musicstyletransfer_tpu/ops/fused_decode.py:494",
        "launches": launches + serving["launches"] + sharded["launches"],
        "max_abs_err": max(k1_errs),
        "ms": numbers["ms"], "plain_ms": numbers["plain_ms"],
        "bound_ms": numbers["bound_ms"], "bound_by": numbers["bound_by"],
        "library_ms": None,
    }]
    for kid, name, replaces in (
            ("K2", "attention_core_forward", "musicstyletransfer_tpu/ops/attention_core.py:203"),
            ("K3", "attention_core_backward", "musicstyletransfer_tpu/ops/attention_core.py:235")):
        ms, plain_ms, lib_ms, bound_ms, bound_by = enc[kid]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "musicstyletransfer_torch/ops/csrc/flash_attention_tc.cu",
            # the wide training path's launches and the wide pipeline's (pipeline_path)
            "replaces": replaces, "launches": train_counts[kid] + pipe["launches"][kid],
            "max_abs_err": core_err[kid], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        })
    for kid, name, replaces in (
            ("K4", "flash_attention_forward", "musicstyletransfer_tpu/ops/flash_attention.py:367"),
            ("K5", "flash_attention_backward", "musicstyletransfer_tpu/ops/flash_attention.py:786")):
        ms, plain_ms, lib_ms, bound_ms, bound_by = flash["encoder"][kid]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "musicstyletransfer_torch/ops/csrc/flash_attention_tc.cu",
            # the long training path's launches, the ring's (ring_path) and the long
            # pipeline's (pipeline_path)
            "replaces": replaces,
            "launches": long_counts[kid] + ring["launches"][kid] + pipe["launches"][kid],
            "max_abs_err": flash_err[kid], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        })
    for label, st in steps.items():
        log(f"{label} training step: " + "; ".join(
            f"{mode} {st[mode]['ms']:.3f} ms ({st[mode]['tokens_per_s']:.0f} target tokens/s, "
            f"{st[mode]['kernel_ms']:.3f} ms of kernels, busy {st[mode]['busy']:.3f}, "
            f"{st[mode]['launches']:.0f} kernels, {st[mode]['host_ops']:.0f} host ops)"
            for mode in ("eager", "graphed")))
    log("GAN training (train-gan.sh): " + "; ".join(
        f"{k} {v['updates_per_s']:.2f} updates/s ({v['host_ops']:.0f} host ops an update, busy "
        f"{v['busy']:.3f})" for k, v in gan.items()))
    log(f"LSTM decode at B=64, T={T}: style_transfer_all_classes {lstm['transfer_ms']:.3f} ms, "
        f"decode_sampled {lstm['decode_ms']:.3f} ms")
    log(f"ring path ({card}): K4 {ring['launches']['K4']} and K5 {ring['launches']['K5']} "
        f"launches over n = {' and '.join(map(str, RING_NS))} at both long shapes, max|err| "
        f"against the whole-T kernels K4 {ring['err']['K4']:.3g}, K5 {ring['err']['K5']:.3g}")
    log(f"pipeline path ({card}): K2-K5 launches {pipe['launches']}; forward + backward ms "
        "(pipelined in lock step, sequential): " + "; ".join(
            f"{tag}: {a:.3f}, {b:.3f}" for tag, (a, b) in pipe["ms"].items()))
    log(f"dist path ({card}): graphed step {dist_ms['world-1 mesh']:.4f} ms on the world-1 mesh "
        f"vs {dist_ms['no mesh']:.4f} without; all-reduce {dist_ms['all_reduce']:.4f} ms")
    log(f"sharded path ({card}): sharded transfer {sharded['sharded_ms']:.4f} ms vs "
        f"{sharded['unsharded_ms']:.4f} unsharded, all-gather {sharded['gather_ms']:.4f} ms; "
        f"GAN DP {gan_dp_rates['world-1 mesh']:.2f} vs {gan_dp_rates['no mesh']:.2f} updates/s")
    log(f"total {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
