#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. Requires CUDA; prints the card's name and power limit (nvidia-smi).
2. Builds K1 (musicstyletransfer_torch/ops/csrc/fused_decode.cu) with nvcc.
3. Holds the kernel against its plain PyTorch version on the card, at the
   canonical decoder shape (D=128, H=8, V=293, B=64, T=130) with seeded
   weights, in float32 and bfloat16: forced-mode logits, greedy tokens and
   scores, the top-k/top-p support of sampled tokens, sample-mode statistics
   over 256 rows, and a pre-LN + per-step-conditioned two-layer decoder.
4. Drives the main path: the shipped models/guitar_bass export through
   Sampling.process_dataset (--gpu) on the first two batches of
   work/data/guitar_bass (batch 32, L=64), writes MIDI, parses every file
   back, and checks that the decode went through the kernel only.
5. Times style_transfer_all_classes at 32 sources x 2 classes, T=130, through
   the kernel and through the plain loop, K1 alone against the plain loop,
   and the p50 latency of one MIDI file -> MIDI transfer.

Exits non-zero on any failure. The last line of standard output is
{"ok": true, "device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

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
    from musicstyletransfer_tpu.midi.vocab import EOS_ID

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
        from musicstyletransfer_tpu.midi.vocab import EOS_ID, PAD_ID

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


def main_path(fd, device):
    """Sampling.process_dataset on the shipped checkpoint, through --gpu."""
    import itertools

    from musicstyletransfer_tpu.cli.flags import get_config
    from musicstyletransfer_tpu.data import Loader, MelodyDataset
    from musicstyletransfer_tpu.midi import smf
    from musicstyletransfer_tpu.midi.codec import tokenize_track
    from musicstyletransfer_tpu.midi.vocab import FEATURE_OFFSET, is_timeshift
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
        names = sorted(os.listdir(out))
        check(len(names) == 2 * 32 * 3, f"expected 192 MIDI files, got {len(names)}")
        notes = 0
        for n in names:
            tracks = smf.read_midifile(os.path.join(out, n)).tracks
            toks = np.concatenate([tokenize_track(t) for t in tracks])
            check(bool((toks >= FEATURE_OFFSET).all()), f"{n}: bad token")
            notes += int(sum(not is_timeshift(int(t)) for t in toks))
        log(f"main path: {len(names)} MIDI files written and parsed back "
            f"({notes} note events); fused_decode launches {launches}, plain "
            f"decode loops on CUDA {plain_runs}")
    return sampler.model, dataset, launches


def time_cuda(fn, n: int) -> float:
    """Mean ms per call over n calls, CUDA events, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def measure(model, dataset, fd, decode):
    """The card's own numbers on the shipped model (bf16)."""
    from musicstyletransfer_tpu.midi import smf
    from musicstyletransfer_tpu.midi.codec import EventBasedMIDIReader, MelodyWriter, melody_from_ids
    from musicstyletransfer_tpu.midi.vocab import PAD_ID, SOS_ID

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
    fd.fused_decode.launches = launches  # timing launches are not the main path's
    log(f"K1 fused_decode B={x0.shape[0]} T={T} bf16 sample: {ms:.4f} / {ms2:.4f} ms; "
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
            "plain_events_per_s": p_eps, "p50_ms": p50}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    log(f"card: {smi.stdout.strip().splitlines()[0]}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    from musicstyletransfer_torch.inference import decode
    from musicstyletransfer_torch.ops import _build
    from musicstyletransfer_torch.ops import fused_decode as fd

    t0 = time.perf_counter()
    _build.build("fused_decode")
    _build.load("fused_decode")
    log(f"build: K1 compiled and loaded in {time.perf_counter() - t0:.1f} s")

    err32 = check_kernel(torch.float32, fd, decode)
    err16 = check_kernel(torch.bfloat16, fd, decode)
    model, dataset, launches = main_path(fd, device)
    numbers = measure(model, dataset, fd, decode)

    print(json.dumps({"kernels": [{
        "name": "fused_decode",
        "route": "cuda",
        "source": "musicstyletransfer_torch/ops/csrc/fused_decode.cu",
        "replaces": "musicstyletransfer_tpu/ops/fused_decode.py:494",
        "launches": launches,
        "max_abs_err": max(err32, err16),
        "ms": numbers["ms"],
        "plain_ms": numbers["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
