#!/usr/bin/env python3
"""Where K1's time goes, by phase: clock64() sums on the card; and K1 on
the serving path's own inputs.

    python3 scripts/k1-phases.py [TREE ...]
    python3 scripts/k1-phases.py --serving [TREE ...]

TREE is the root of a checkout of this repository (default: this one); give
several to compare, e.g. a parent unpacked with ``git archive`` under
build/, in turns (parent, change, change, parent).

By default, for each tree the script builds that tree's ``fused_decode.cu``
with its timing probes on (``-DMST_K1_PHASES``) into build/phases/ and runs
that tree's ``fused_decode`` wrapper at three shapes: the canonical decoder
(B=64, T=130, bf16, sample), the wide decoder (16 rows, D=512 x 2, 16
heads, pre-LN, T=1026, greedy) and the long decoder (16 rows, D=256 x 2, 8
heads, post-LN, per_step, T=4094, greedy), all with seeded weights. Each
phase's sum is taken by thread 0 of every block and summed over the blocks;
printed as the mean per block, as a share of the block's whole run, and as
ms of the launch (the share times the launch's CUDA-event time, one launch
without probes timed beside it). Phase names: the products (qkv, o, ff1,
ff2, head), attention (scores, softmax, P.V; the first pass over the keys
counts as scores and the second as P.V), LayerNorm, token choice; "block
barriers" and "cluster barriers" are the waits inside __syncthreads and the
cluster barrier, already counted in the phase they end.

With ``--serving``, each tree's own package loads the shipped
models/guitar_bass export on the card, encodes the first batch of
work/data/guitar_bass (32 sources, L=64) into both classes, and times that
tree's ``fused_decode`` at B=64, T=130, bf16, sample mode, seed 5: the mean
of 50 launches by CUDA events after one warm-up, twice.

Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import subprocess
import sys
import time

import numpy as np

PHASES = ["qkv", "scores", "softmax", "P.V", "o", "LayerNorm", "ff1", "ff2", "residual",
          "head", "token choice", "embedding", "whole run", "block barriers",
          "cluster barriers", "spare"]


def build(tree: str) -> ctypes.CDLL:
    from musicstyletransfer_torch.ops import _build

    with open(os.path.join(tree, "musicstyletransfer_torch", "ops", "csrc", "fused_decode.cu")) as f:
        src = f.read()
    if "MST_K1_PHASES" not in src:
        raise SystemExit(f"{tree}: fused_decode.cu has no timing probes (MST_K1_PHASES)")
    flags = [*_build.NVCC_FLAGS, "-DMST_K1_PHASES"]
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "build", "phases")
    os.makedirs(out_dir, exist_ok=True)
    tag = hashlib.sha256((src + " ".join(flags)).encode()).hexdigest()[:12]
    cu, so = os.path.join(out_dir, f"k1-{tag}.cu"), os.path.join(out_dir, f"k1-{tag}.so")
    if os.path.exists(so):
        return ctypes.CDLL(so)
    with open(cu, "w") as f:
        f.write(src)
    # the copy includes headers of the tree's csrc/ by their names
    inc = ["-I", os.path.join(tree, "musicstyletransfer_torch", "ops", "csrc")]
    t0 = time.perf_counter()
    proc = subprocess.run([_build.find_nvcc(), *flags, *inc, "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {cu}:\n{proc.stderr}")
    print(f"built {cu} in {time.perf_counter() - t0:.1f} s", flush=True)
    return ctypes.CDLL(so)


def use_tree(tree: str) -> None:
    """Import ``musicstyletransfer_torch`` from ``tree`` from now on."""
    for mod in [m for m in sys.modules if m.startswith("musicstyletransfer_torch")]:
        del sys.modules[mod]
    for other in [p for p in sys.path
                  if os.path.isdir(os.path.join(p, "musicstyletransfer_torch"))]:
        sys.path.remove(other)
    sys.path.insert(0, tree)


def time_launches(fn, n: int) -> float:
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def serving(trees) -> None:
    import torch

    repo = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    for tree in trees:
        use_tree(tree)
        data = importlib.import_module("musicstyletransfer_torch.data")
        decode = importlib.import_module("musicstyletransfer_torch.inference.decode")
        sampler = importlib.import_module("musicstyletransfer_torch.inference.sampler")
        fd = importlib.import_module("musicstyletransfer_torch.ops.fused_decode")
        loader = data.Loader(os.path.join(repo, "work", "data", "guitar_bass"), 64)
        batch = next(iter(data.MelodyDataset(32, loader.max_sequence_length, loader.melodies)))
        model = sampler.load_inference_model(os.path.join(repo, "models", "guitar_bass"), -1,
                                             torch.device("cuda"))
        tokens = torch.as_tensor(batch.tokens, dtype=torch.long).cuda()
        seq_lens = torch.as_tensor(batch.seq_lens, dtype=torch.long).cuda()
        with torch.inference_mode():
            classes = torch.arange(2, device="cuda").repeat_interleave(tokens.shape[0])
            z = decode._encode_deterministic(model, tokens.repeat(2, 1), seq_lens.repeat(2),
                                             classes)
            x0 = model.decode_init(z, classes).contiguous()
        ms = [time_launches(lambda: fd.fused_decode(model, x0, 130, 5), 50) for _ in range(2)]
        seqs, _ = fd.fused_decode(model, x0, 130, 5)
        steps = int((seqs != 0).sum(1).max())
        print(f"{tree}: K1 B=64 T=130 bf16 sample on the shipped model: {ms[0]:.4f} / "
              f"{ms[1]:.4f} ms a launch (longest row {steps} tokens; plan "
              f"{fd.plan_for(model, 64, 130)})", flush=True)


def phases(trees) -> None:
    import torch

    for tree in trees:
        use_tree(tree)
        timed_lib = build(tree)
        fd = importlib.import_module("musicstyletransfer_torch.ops.fused_decode")
        models = importlib.import_module("musicstyletransfer_torch.models")
        plain_lib = fd._build.load("fused_decode")
        timed_lib.mst_phase_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
        print(f"== {tree}", flush=True)
        for label, dec, latent, rows, steps, cond, mode in (
                ("canonical", dict(model_size=128, num_layers=1, num_heads=8), 256, 64, 130,
                 "initial", "sample"),
                ("wide", dict(model_size=512, num_layers=2, num_heads=16, norm_scheme="pre"),
                 1024, 16, 1026, "initial", "greedy"),
                ("long", dict(model_size=256, num_layers=2, num_heads=8), 512, 16, 4094,
                 "per_step", "greedy")):
            cfg = models.ModelConfig(
                encoder_config=models.EncoderConfig(
                    transformer_config=models.TransformerConfig(model_size=64), latent_dim=latent),
                decoder_config=models.DecoderConfig(
                    transformer_config=models.TransformerConfig(**dec), latent_dim=latent,
                    class_conditioning=cond), dtype="bfloat16")
            torch.manual_seed(0)
            model = models.StyleVAE(cfg).cuda().eval()
            g = np.random.default_rng(5)
            z = torch.as_tensor(g.normal(size=(rows, latent)), dtype=torch.float32).cuda()
            classes = torch.as_tensor(g.integers(0, 2, rows)).cuda()
            with torch.inference_mode():
                x0 = model.decode_init(z, classes).contiguous()

            def run():
                return fd.fused_decode(model, x0, steps, 5, mode=mode, classes=classes)

            fd._build._loaded["fused_decode"] = plain_lib
            ms = time_launches(run, 1)
            seqs, _ = run()
            fd._build._loaded["fused_decode"] = timed_lib
            timed_lib.mst_phase_reset()
            seqs2, _ = run()
            torch.cuda.synchronize()
            fd._build._loaded["fused_decode"] = plain_lib
            sums = (ctypes.c_ulonglong * 16)()
            timed_lib.mst_phase_read(sums)
            nblocks = fd.plan_for(model, rows, steps)["blocks"]
            whole = sums[12] / nblocks
            same = bool(torch.equal(seqs, seqs2))
            print(f"{label}: {rows} rows, T={steps}, {mode}, bf16; launch {ms:.3f} ms without "
                  f"probes; {nblocks} blocks; {whole:.0f} clocks a block; probes change the "
                  f"tokens: {not same}", flush=True)
            for i, name in enumerate(PHASES):
                if i in (12, 15) or sums[i] == 0:
                    continue
                share = sums[i] / nblocks / whole
                print(f"  {name:16s} {sums[i] / nblocks:14.0f} clocks  {share:6.3f}  "
                      f"{share * ms:9.3f} ms", flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    mode = serving if args[:1] == ["--serving"] else phases
    trees = [os.path.abspath(t) for t in args[mode is serving:]]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    mode(trees or [os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))])
