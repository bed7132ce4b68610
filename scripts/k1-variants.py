#!/usr/bin/env python3
"""K1's time under other plans than ``fused_decode.plan``'s, and of
text-substituted variants of its source, on the card.

    python3 scripts/k1-variants.py plans
    python3 scripts/k1-variants.py sources
    python3 scripts/k1-variants.py serving [NAME ...]

Builds csrc/fused_decode.cu as the package does and launches it at the
three recipe decoders with seeded bf16 weights (the canonical decoder, 64
rows, T=130, sample; the wide decoder, 16 rows, T=1026, greedy; the long
decoder, 16 rows, T=4094, greedy; every row runs to max_len) under every
(rows a group, blocks a cluster, weights resident or streamed) that fits a
block's shared memory, the planned one marked. Prints
each plan's ms a launch (CUDA events, the mean of ``REPS`` launches after
one warm-up) and whether its tokens equal the planned launch's (groups and clusters change the order of some float32
sums, so in bf16 a token may flip where two logits nearly tie).

``sources`` builds each variant of ``SOURCES`` into build/variants/ (all
nvcc processes at once, ``-Xptxas -v``: its registers and spills are
printed), holds its float32 forced logits to the plain version's at a
short length, and times it at the three shapes under the planned plan.

``serving`` builds the named variants (default: all) and times each on the
serving path's own launch: the shipped models/guitar_bass export, the first
batch of work/data/guitar_bass (32 sources, L=64) encoded into both
classes, B=64, T=130, bf16, seed 5, in sample mode as the sampler runs it
(no top-k or top-p) and with top-k 30 and top-p 0.9. The variants take
turns over ``ROUNDS`` rounds (A B, B A, ...), each time the mean of 50
launches by CUDA events after one warm-up; each variant's tokens are held
to the first variant's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from musicstyletransfer_torch.models import (  # noqa: E402
    DecoderConfig, EncoderConfig, ModelConfig, StyleVAE, TransformerConfig)
from musicstyletransfer_torch.ops import _build  # noqa: E402
from musicstyletransfer_torch.ops import fused_decode as fd  # noqa: E402

THREADS = "constexpr int kThreads = 256,"
# name -> [(old, new), ...] applied to csrc/fused_decode.cu
SOURCES = {
    "as committed": [],
    "512 threads": [(THREADS, "constexpr int kThreads = 512,")],
    "every device function inlined": [("__device__ void ", "__device__ __forceinline__ void ",
                                       "every")],
    "token choice from shared memory at every V": [
        ("V <= 32 * kMaxVLane ? pick_narrow(a, lg, noise, b, t, lse)\n"
         "                                        : pick_wide(", "pick_wide(")],
}
ROUNDS = 4

REPS = 3
SHAPES = (
    ("canonical", dict(model_size=128, num_layers=1, num_heads=8), 256, 64, 130, "initial",
     "sample"),
    ("wide", dict(model_size=512, num_layers=2, num_heads=16, norm_scheme="pre"), 1024, 16,
     1026, "initial", "greedy"),
    ("long", dict(model_size=256, num_layers=2, num_heads=8), 512, 16, 4094, "per_step",
     "greedy"),
)


def time_launch(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def shape_model(dec, latent, rows, cond, dtype="bfloat16"):
    cfg = ModelConfig(
        encoder_config=EncoderConfig(transformer_config=TransformerConfig(model_size=64),
                                     latent_dim=latent),
        decoder_config=DecoderConfig(transformer_config=TransformerConfig(**dec),
                                     latent_dim=latent, class_conditioning=cond),
        dtype=dtype)
    torch.manual_seed(0)
    model = StyleVAE(cfg).cuda().eval()
    g = np.random.default_rng(5)
    z = torch.as_tensor(g.normal(size=(rows, latent)), dtype=torch.float32).cuda()
    classes = torch.as_tensor(g.integers(0, 2, rows)).cuda()
    with torch.inference_mode():
        x0 = model.decode_init(z, classes).contiguous()
    return model, x0, classes


def build_variant(name, subs):
    with open(_build.CSRC / "fused_decode.cu") as f:
        src = f.read()
    for old, new, *every in subs:  # a third element: replace every occurrence
        if src.count(old) != 1 and not (every and src.count(old)):
            raise SystemExit(f"variant {name!r}: {old[:50]!r} found {src.count(old)} times")
        src = src.replace(old, new)
    out = _build.REPO_ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(src.encode()).hexdigest()[:12]
    cu, so = out / f"k1-{tag}.cu", out / f"k1-{tag}.so"
    cu.write_text(src)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        return name, None, proc.stderr[-2000:]
    spills = " | ".join(re.findall(r"\d+ bytes stack frame.*|Used \d+ registers", proc.stderr))
    return name, str(so), spills


def sources() -> None:
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(lambda kv: build_variant(*kv), SOURCES.items()))
    for name, so, info in built:
        print(f"== {name}: {info}", flush=True)
        if so is None:
            continue
        fd._build._loaded["fused_decode"] = ctypes.CDLL(so)
        model, x0, classes = shape_model(dict(model_size=128, num_layers=2, num_heads=8,
                                              norm_scheme="pre"), 32, 8, "per_step", "float32")
        forced = torch.as_tensor(np.random.default_rng(1).integers(3, 293, (8, 24)),
                                 dtype=torch.int32).cuda()
        _, _, kl = fd.fused_decode(model, x0, 24, 0, mode="forced", forced_tokens=forced,
                                   classes=classes)
        _, _, pl = fd.fused_decode_reference(model, x0, 24, 0, mode="forced",
                                             forced_tokens=forced, classes=classes)
        err = float((kl - pl).abs().max())
        times = []
        for label, dec, latent, rows, steps, cond, mode in SHAPES:
            model, x0, classes = shape_model(dec, latent, rows, cond)
            times.append(time_launch(lambda: fd.fused_decode(model, x0, steps, 5, mode=mode,
                                                             classes=classes), 2))
        print(f"  float32 forced max|err| {err:.3g}; canonical {times[0]:.3f} ms, wide "
              f"{times[1]:.3f} ms, long {times[2]:.3f} ms a launch", flush=True)


def serving(names) -> None:
    from musicstyletransfer_torch.data import Loader, MelodyDataset
    from musicstyletransfer_torch.inference import decode
    from musicstyletransfer_torch.inference.sampler import load_inference_model

    names = names or list(SOURCES)
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(lambda n: build_variant(n, SOURCES[n]), names))
    libs = {}
    for name, so, info in built:
        print(f"== {name}: {info}", flush=True)
        if so is not None:
            libs[name] = ctypes.CDLL(so)
    repo = _build.REPO_ROOT
    loader = Loader(str(repo / "work" / "data" / "guitar_bass"), 64)
    batch = next(iter(MelodyDataset(32, loader.max_sequence_length, loader.melodies)))
    model = load_inference_model(str(repo / "models" / "guitar_bass"), -1, torch.device("cuda"))
    tokens = torch.as_tensor(batch.tokens, dtype=torch.long).cuda()
    seq_lens = torch.as_tensor(batch.seq_lens, dtype=torch.long).cuda()
    with torch.inference_mode():
        classes = torch.arange(2, device="cuda").repeat_interleave(tokens.shape[0])
        z = decode._encode_deterministic(model, tokens.repeat(2, 1), seq_lens.repeat(2), classes)
        x0 = model.decode_init(z, classes).contiguous()
    for label, kw in (("sample", {}), ("sample top-k 30 top-p 0.9", dict(top_k=30, top_p=0.9))):
        times = {n: [] for n in libs}
        want = None
        for r in range(ROUNDS):
            for name in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
                fd._build._loaded["fused_decode"] = libs[name]
                run = lambda: fd.fused_decode(model, x0, 130, 5, **kw)  # noqa: E731
                times[name].append(time_launch(run, 50))
                seqs, _ = run()
                want = seqs if want is None else want
                if not torch.equal(seqs, want):
                    print(f"  {name}: tokens differ from {list(libs)[0]!r}", flush=True)
        for name, ms in times.items():
            print(f"  {label}, B=64 T=130 bf16, {name}: " + " / ".join(f"{t:.4f}" for t in ms)
                  + f" ms a launch (least {min(ms):.4f})", flush=True)


def plans() -> None:
    planned, max_cluster = fd.plan, fd.MAX_CLUSTER
    for label, dec, latent, rows, steps, cond, mode in SHAPES:
        model, x0, classes = shape_model(dec, latent, rows, cond)
        chosen = fd.plan_for(model, rows, steps)
        D, H, NL = dec["model_size"], dec["num_heads"], dec["num_layers"]
        shape = (rows, D, H, 4 * D, 293, NL, steps, 2)

        def run():
            return fd.fused_decode(model, x0, steps, 5, mode=mode, classes=classes)

        want, _ = run()
        print(f"== {label}: {rows} rows, T={steps}, {mode}, bf16; planned {chosen}; clusters "
              f"the card runs at once {fd.clusters_held(x0.device)}", flush=True)
        # one block a group only where the whole decoder is small
        for c in ((1,) if label == "canonical" else ()) + (2, 4, 8):
            fd.MAX_CLUSTER = c
            try:
                base = planned(*shape)
            finally:
                fd.MAX_CLUSTER = max_cluster
            if base["cluster"] != c:
                continue
            for r in sorted({1, 2, 4, 8, 16, chosen["rows"]}):
                for resident in (False, True):
                    smem = fd.smem_bytes(r, c, D, H, 4 * D, 293, 2, NL, resident)
                    if r > rows or smem > fd._SMEM_LIMIT:
                        continue
                    g = -(-rows // r)
                    p = {**base, "rows": r, "groups": g, "blocks": g * c, "resident": resident,
                         "smem": smem}
                    fd.plan = lambda *a, _p=p, **k: _p
                    try:
                        ms = time_launch(run, REPS)
                        got, _ = run()
                        torch.cuda.synchronize()
                    except RuntimeError as exc:
                        print(f"  rows {r:2d} cluster {c} resident {resident:d}: {exc}", flush=True)
                        continue
                    finally:
                        fd.plan = planned
                    mark = " <- planned" if (r, c, resident) == (
                        chosen["rows"], chosen["cluster"], chosen["resident"]) else ""
                    same = float((got == want).all(1).float().mean())
                    print(f"  rows {r:2d} cluster {c} resident {resident:d} groups {g:3d}: "
                          f"{ms:10.3f} ms a launch, tokens as planned {same:.3f}{mark}",
                          flush=True)


if __name__ == "__main__":
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    mode = sys.argv[1] if len(sys.argv) > 1 else "plans"
    if mode == "serving":
        serving(sys.argv[2:])
    else:
        {"plans": plans, "sources": sources}[mode]()
