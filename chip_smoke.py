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
   over T=4094.
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
6. Serving path: the shipped models/guitar_bass export through
   Sampling.process_dataset on the first two batches of work/data/guitar_bass
   (batch 32, L=64); the MIDI parses back, the decode went through K1 only.
7. Wide training path: musicstyletransfer_torch.cli.main with
   scripts/train-vae-wide.sh's flags (L=512, batch 8, bf16, pre-LN, the
   attention core) for two epochs with a checkpoint after each; a copy of
   the run resumed from the first checkpoint for one epoch, whose first
   logged step must equal the uninterrupted run's; cli.sample on the
   resumed checkpoint, whose MIDI parses back. Loss and gradient norm stay
   finite, no update is skipped, K3 runs on every attention layer of every
   step, every K2 and K3 launch on the tensor-core kernels, and no plain
   version runs on the card.
8. Long training path: cli.main with scripts/train-vae-long.sh's flags
   (L=2046, batch 4, post-LN, per_step, --ring-attention --tp 1) for two
   epochs (24 steps) with a checkpoint after each, then cli.sample on the
   checkpoint at max_len 4094, whose MIDI parses back. K5 runs on every
   attention layer of every step, every K4 and K5 launch on the tensor-core
   kernels, K2/K3 never, no plain version on the card; loss and gradient
   norm finite, no update skipped.
9. Times (CUDA events, beside the card's name and power limit): the serving
   transfer, K1 against its plain loop, p50 MIDI->MIDI latency; K2/K3 at
   both wide shapes and K4/K5 at both long shapes and at T=8192 beside their
   bounds, their plain versions and torch's scaled_dot_product_attention,
   and their wrappers' host time a call; the wide and the long training
   step, their target tokens per second and the attention kernels' share of
   them (torch.profiler).

Exits non-zero on any failure. The last line of standard output is
{"ok": true, "device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

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
    z = torch.as_tensor(g.normal(size=(rows, 256)), dtype=torch.float32).cuda()
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


def check_decoder(fd, dtype: torch.dtype, label: str, dec, latent: int, steps: int,
                  conditioning: str = "initial", reps: int = 3) -> float:
    """K1 at a recipe's decoder ``dec`` over T=``steps`` positions on 8 rows:
    forced logits against the plain loop, and every greedy token the plain
    argmax on its prefix; returns the forced logits' max abs error."""
    from musicstyletransfer_torch.models import (
        DecoderConfig, EncoderConfig, ModelConfig, StyleVAE, TransformerConfig)

    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    rows = 8
    cfg = ModelConfig(
        encoder_config=EncoderConfig(transformer_config=TransformerConfig(model_size=64),
                                     latent_dim=latent),
        decoder_config=DecoderConfig(transformer_config=dec, latent_dim=latent,
                                     class_conditioning=conditioning), dtype=name)
    torch.manual_seed(0)
    model = StyleVAE(cfg).cuda().eval()
    g = np.random.default_rng(5)
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
    _, _, gl = fd.fused_decode_reference(model, x0, steps, 0, mode="forced", forced_tokens=kseq,
                                         classes=classes)
    torch.cuda.synchronize()
    err = float((kl - pl).abs().max())
    check(bool(torch.isfinite(kl).all()), f"{label} K1 {name}: non-finite logits")
    check(err <= TOL_LOGITS[dtype],
          f"{label} K1 {name} forced max|err| {err} > {TOL_LOGITS[dtype]}")
    chosen = gl.gather(2, kseq.long()[:, :, None])[:, :, 0]
    gap = float((gl.max(-1).values - chosen)[live_mask(kseq)].max())
    check(gap <= TOL_LOGITS[dtype],
          f"{label} K1 {name} greedy: a token {gap} below the plain argmax")
    ms = time_cuda(lambda: fd.fused_decode(model, x0, steps, 0, mode="greedy", classes=classes),
                   reps)
    log(f"[{name}] {label} decoder D={dec.model_size} x{dec.num_layers} layers, "
        f"{dec.num_heads} heads, {dec.norm_scheme}-LN, {conditioning}, T={steps}, {rows} rows: "
        f"forced max|err| {err:.3g} (tol {TOL_LOGITS[dtype]}), greedy max argmax gap {gap:.3g}; "
        f"K1 greedy {ms:.3f} ms a launch")
    return err


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


def recipe_argv(script: str, data: str, model_output: str, out_samples: str):
    """scripts/<script>'s flags, shell defaults (${TP:-1}) taken, with its
    paths replaced."""
    with open(os.path.join(REPO, "scripts", script)) as f:
        text = f.read()
    body = text.split("musicstyletransfer_tpu.cli.main", 1)[1].split('"$@"', 1)[0]
    body = re.sub(r"\$\{\w+:-([^}]*)\}", r"\1", body)
    argv = shlex.split(body.replace("\\\n", " "))
    subs = {"--data": data, "--model-output": model_output, "--out-samples": out_samples}
    for i, a in enumerate(argv[:-1]):
        if a in subs:
            argv[i + 1] = subs[a]
    for flag in ("--use-flash-attention", "--max-seq-len", "--batch-size"):
        check(flag in argv, f"{script} lost {flag}")
    return argv


PLAIN = ("K1 plain", "K2 plain", "K3 plain", "XLA-backward twin", "K4 plain", "K5 plain")


def counts(reset: bool = False) -> dict:
    """Launch counts of K1-K5 (K2-K5 also on their tensor-core kernels
    alone) and runs of their plain versions on CUDA."""
    from musicstyletransfer_torch.ops import attention_core as ac
    from musicstyletransfer_torch.ops import flash_attention as fa
    from musicstyletransfer_torch.ops import fused_decode as fd

    names = {"K1": (fd.fused_decode, "launches"), "K2": (ac.core_forward, "launches"),
             "K3": (ac.core_backward, "launches"), "K4": (fa.flash_forward, "launches"),
             "K5": (fa.flash_backward, "launches"),
             "K2 tc": (ac.core_forward, "tc_launches"),
             "K3 tc": (ac.core_backward, "tc_launches"),
             "K4 tc": (fa.flash_forward, "tc_launches"),
             "K5 tc": (fa.flash_backward, "tc_launches"),
             "K1 plain": (fd.fused_decode_reference, "cuda_runs"),
             "K2 plain": (ac.core_forward_reference, "cuda_runs"),
             "K3 plain": (ac.core_backward_reference, "cuda_runs"),
             "XLA-backward twin": (ac.core_xla_backward, "cuda_runs"),
             "K4 plain": (fa.flash_forward_reference, "cuda_runs"),
             "K5 plain": (fa.flash_backward_reference, "cuda_runs")}
    out = {}
    for k, (fn, attr) in names.items():
        out[k] = getattr(fn, attr)
        if reset:
            setattr(fn, attr, 0)
    return out


def train_lines(path: str):
    with open(path) as f:
        lines = [json.loads(x) for x in f]
    return lines


def check_train_log(lines, label: str) -> None:
    train = [x for x in lines if "grad_norm" in x]
    check(train, f"{label}: no training metrics logged")
    for x in train:
        for k in ("ce_loss", "total_loss", "grad_norm"):
            check(isinstance(x[k], float) and math.isfinite(x[k]),
                  f"{label}: {k} at step {x['step']} is {x[k]}")
    skipped = [x["nonfinite_updates_skipped"] for x in lines if "nonfinite_updates_skipped" in x]
    check(skipped and all(v == 0 for v in skipped), f"{label}: skipped updates {skipped}")


def train_path(ac, fd, tmp: str) -> dict:
    """The wide recipe through cli.main, a resumed run, and cli.sample."""
    from musicstyletransfer_torch.cli import main as cli_main
    from musicstyletransfer_torch.cli import sample as cli_sample
    from musicstyletransfer_torch.data import Loader, MelodyDataset, load_dataset

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
    for k in PLAIN:
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
    for k in PLAIN:
        check(c[k] == 0, f"{k} ran {c[k]} times on CUDA in cli.sample")
    log(f"sample path: cli.sample on the resumed checkpoint, max_len 1026: {len(names)} MIDI "
        f"files written and parsed back ({notes} note events) in {wall:.1f} s; launches {c}")
    return main_counts


def long_path(tmp: str) -> dict:
    """The long recipe through cli.main for two epochs, then cli.sample on its
    checkpoint at max_len 2 * (L + 1) = 4094; returns the training run's
    launch counts."""
    from musicstyletransfer_torch.cli import main as cli_main
    from musicstyletransfer_torch.cli import sample as cli_sample
    from musicstyletransfer_torch.data import Loader, MelodyDataset, load_dataset

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
    for k in PLAIN:
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
    for k in PLAIN:
        check(c[k] == 0, f"{k} ran {c[k]} times on CUDA in cli.sample")
    log(f"long sample path: cli.sample on the long checkpoint, max_len {2 * (LONG_L + 1)}: "
        f"{len(names)} MIDI files written and parsed back ({notes} note events) in {wall:.1f} s; "
        f"launches {c}")
    return main_counts


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


def measure_training(batch, label: str, script: str, kernels: dict) -> dict:
    """ms per training step of a recipe (the CLI's model and optimizer),
    target tokens per second, and the share of the step's device time of
    each kernel in ``kernels`` ({id: substrings of its kernels' symbols})."""
    from torch.profiler import ProfilerActivity, profile

    from types import SimpleNamespace

    from musicstyletransfer_torch.cli.flags import build_parser
    from musicstyletransfer_torch.cli.main import create_model_config
    from musicstyletransfer_torch.midi.vocab import NUM_EVENTS, PAD_ID
    from musicstyletransfer_torch.models.vae import StyleVAE, init_params
    from musicstyletransfer_torch.training.optimizer import Adam, OptimizerConfig
    from musicstyletransfer_torch.training.train_step import LossConfig, batch_tensors, train_step

    args, _ = build_parser().parse_known_args(recipe_argv(script, "-", "-", "-"))

    corpus = SimpleNamespace(num_classes=lambda: 2, num_tokens=lambda: NUM_EVENTS)
    model = init_params(StyleVAE(create_model_config(args, corpus)), 0).cuda()
    opt = Adam(list(model.parameters()), OptimizerConfig(
        args.optimizer, args.optimizer_params, args.learning_rate))
    loss_cfg = LossConfig(kl_weight=args.kl_loss, kl_anneal_steps=args.kl_anneal_steps,
                          free_bits=args.free_bits)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tensors = batch_tensors(batch, "cuda")
    state = {"step": 0, "acc": None}

    def step():
        state["acc"] = train_step(model, opt, loss_cfg, state["step"], state["acc"],
                                  *tensors, generator=gen)
        state["step"] += 1

    for _ in range(3):
        step()
    ms = [time_cuda(step, 10), time_cuda(step, 10)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 100
    tokens = int((tensors[3] != PAD_ID).sum())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3

    def dev(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    # Device-side events only: a CPU op (an autograd Function around a
    # ctypes launch, aten::mm) also carries its kernels' time as its own.
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    check(events, "torch.profiler recorded no device events")
    total = sum(dev(e) for e in events) / 1e3  # ms over 5 steps
    ms_by = {k: sum(dev(e) for e in events if any(sym in e.key for sym in syms)) / 1e3
             for k, syms in kernels.items()}
    res = {"ms": min(ms), "host_ms": host_ms, "tokens_per_s": tokens / (min(ms) / 1e3),
           "shares": {k: v / max(total, 1e-9) for k, v in ms_by.items()},
           "busy": total / max(prof_wall, 1e-9)}
    top = sorted(events, key=dev, reverse=True)[:8]
    log(f"{label} training step (B={args.batch_size}, L={args.max_seq_len}, {args.dtype}, Adam "
        f"+ clips): {ms[0]:.3f} / {ms[1]:.3f} ms (CUDA events, 10 steps each), {host_ms:.3f} ms "
        f"host clock; {tokens} target tokens -> {res['tokens_per_s']:.0f} tokens/s; profiler "
        f"(5 steps, {prof_wall:.1f} ms wall): device busy {res['busy']:.3f}, {total / 5:.3f} "
        "ms/step of kernels, " + ", ".join(
            f"{k} {v / 5:.3f} ms/step ({res['shares'][k]:.3f})" for k, v in ms_by.items()))
    log("  top device time: " + "; ".join(f"{e.key[:70]} {dev(e) / 5e3:.3f} ms/step ({e.count // 5}/step)"
                                         for e in top))
    # Where the host spends the step (the profiler's own cost included): what
    # holds the card back where busy is low.
    host = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA]
    host_total = sum(e.self_cpu_time_total for e in host) / 5e3
    host_top = sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    log(f"  top host time ({host_total:.1f} ms/step of host ops, {sum(e.count for e in host) // 5} "
        "ops/step): " + "; ".join(f"{e.key[:40]} {e.self_cpu_time_total / 5e3:.2f} ms/step "
                                  f"({e.count // 5}/step)" for e in host_top))
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
        f"(bound {bound_ms:.5f} ms, {bound_by}); plain loop {plain_ms:.3f} / {plain_ms2:.3f} ms")

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
    k1_errs = [err32, err16]
    for dt in (torch.float32, torch.bfloat16):
        k1_errs.append(check_decoder(fd, dt, "wide", wide_dec, 1024, 1026))
        k1_errs.append(check_decoder(fd, dt, "long", long_dec, 512, 2 * (LONG_L + 1),
                                     "per_step", reps=1))
    core_err = check_core(ac)
    corpus = os.path.join(REPO, "work", "data", "guitar_bass")
    long_batch = next(iter(MelodyDataset(LONG_B, LONG_L, Loader(corpus, LONG_L).melodies)))
    flash_err = check_flash(fa, long_batch.seq_lens)

    counts(reset=True)
    model, dataset, launches = main_path(fd, device)
    with tempfile.TemporaryDirectory() as tmp:
        train_counts = train_path(ac, fd, tmp)
        long_counts = long_path(tmp)

    numbers = measure(model, dataset, fd, decode)
    wide_batch = next(iter(MelodyDataset(8, 512, Loader(corpus, 512).melodies)))
    core = measure_core(ac, wide_batch)
    step = measure_training(wide_batch, "wide", "train-vae-wide.sh",
                            {"K2": ("core_fwd_kernel_tc",),
                             "K3": ("core_bwd_dq_kernel_tc", "core_bwd_dkdv_kernel_tc")})
    flash = measure_flash(fa, ac, long_batch)
    long_step = measure_training(long_batch, "long", "train-vae-long.sh",
                                 {"K4": ("flash_fwd_kernel_tc",), "K5": ("flash_bwd_",)})
    log(f"timings above on: {card}")

    enc = core["encoder"]
    kernels = [{
        "name": "fused_decode", "route": "cuda",
        "source": "musicstyletransfer_torch/ops/csrc/fused_decode.cu",
        "replaces": "musicstyletransfer_tpu/ops/fused_decode.py:494",
        "launches": launches,
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
            "replaces": replaces, "launches": train_counts[kid],
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
            "replaces": replaces, "launches": long_counts[kid],
            "max_abs_err": flash_err[kid], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        })
    for label, st in (("wide", step), ("long", long_step)):
        log(f"{label} training step {st['ms']:.3f} ms, {st['tokens_per_s']:.0f} target tokens/s, "
            "kernel shares " + ", ".join(f"{k} {v:.3f}" for k, v in st["shares"].items()))
    log(f"total {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
