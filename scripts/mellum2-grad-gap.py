#!/usr/bin/env python3
"""Where the mellum2_train check's ``grad_gap`` comes from, on the card at
the cell's own size: each leaf's first-step gradient norm of the program
(stage A's first group, through the cell's own driver) against the float32
reference's, with the program's attention changed one piece at a time:

    python3 scripts/mellum2-grad-gap.py --seed 2200001936 \\
        [--variants flash,no_out_lo,k5_float32,dense_encoder]

- ``flash``: the program as it trains (bf16 K4/K5; K5's delta from
  out + out_lo);
- ``no_out_lo``: K5's delta from the bf16 out alone;
- ``k5_float32``: the encoder's K5 (hd 64) on float32 copies of its bf16
  inputs (q, k, v, dO, out + out_lo), its gradients rounded back to bf16:
  K5 without bf16 operands for its products;
- ``dense_encoder``: the encoder's attention dense (``use_flash_attention``
  off) in place of K4/K5.

One JSON line a variant, and one for the reference in bf16 (the witness):
``grad_gap`` (the check's worst leaf's gap, ``train_window.rel_gaps``), its
leaf, and the gaps of the encoder's layer-0 attention kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "benchmark"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from harness import Cell, Context  # noqa: E402
from reference import mellum2 as mref  # noqa: E402
from reference.model import Numerics  # noqa: E402

from musicstyletransfer_torch.models.config import ModelConfig  # noqa: E402
from musicstyletransfer_torch.ops import flash_attention as fa  # noqa: E402

VARIANTS = ("flash", "no_out_lo", "k5_float32", "dense_encoder")


def k5_float32(orig):
    """FlashAttention.backward with the hd 64 launches on float32 copies."""
    def backward(ctx, g_out, g_lse):
        q, k, v, key_lens, lse, out, out_lo = ctx.saved_tensors
        if q.shape[-1] != 64 or g_out is None:
            return orig(ctx, g_out, g_lse)
        causal, sm_scale, extra = ctx.config
        o32 = out.float() + out_lo.float()
        dq, dk, dv = fa.flash_backward(q.float(), k.float(), v.float(), key_lens, lse, o32,
                                       g_out.float(), causal, sm_scale,
                                       None if g_lse is None else g_lse.contiguous(), **extra)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None
    return staticmethod(backward)


def dense_encoder(orig):
    """The driver's ``model_config`` with the encoder off the flash route."""
    def model_config(cfg):
        mc = orig(cfg)
        enc = mc.encoder_config
        return ModelConfig(
            encoder_config=dataclasses.replace(enc, transformer_config=dataclasses.replace(
                enc.transformer_config, use_flash_attention=False)),
            decoder_config=mc.decoder_config, dtype=mc.dtype)
    return model_config


def program_grads(cell, driver, seed: int, device, variant: str):
    """(leaf names, the program's first-step gradient norms, the check's
    batches) with ``variant``'s change in place: set-up's first group
    alone."""
    saved = (fa.new_out_lo, fa.FlashAttention.backward, driver.model_config,
             driver.tw.check_groups, driver.B_GROUPS)
    if variant == "no_out_lo":
        fa.new_out_lo = lambda q: None
    elif variant == "k5_float32":
        fa.FlashAttention.backward = k5_float32(saved[1])
    elif variant == "dense_encoder":
        driver.model_config = dense_encoder(saved[2])
    driver.tw.check_groups = lambda t: (max(1, t["steps_per_dispatch"]), 1)
    driver.B_GROUPS = 0
    ctx = Context(cell, seed, 1.0, False, device, time.perf_counter())
    ctx.traffic = {**ctx.traffic, "warmup_groups": 0}
    try:
        driver.setup(ctx)
        out = ctx.names, ctx.prog["grad"], driver.host_batches(ctx)
        driver.release(ctx)
    finally:
        (fa.new_out_lo, fa.FlashAttention.backward, driver.model_config,
         driver.tw.check_groups, driver.B_GROUPS) = saved
    return out


def reference_grads(cfg, batches, seed: int, names, kind: str, device) -> list:
    """The reference's first-step gradient norms by leaf (``train_window``'s
    stage A, first group) in precision ``kind``."""
    n = max(1, cfg["train"]["steps_per_dispatch"])
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    with mref.no_tf32():
        p0 = mref.init_params(cfg, seed, device)
        r = mref.train_steps(p0, cfg, batches[:n], gen, Numerics(kind), moment_after=n)
        return [float(r["grad"][k].norm()) for k in names]


def report(label, names, prog, refr, rel_gaps) -> dict:
    gaps = rel_gaps(prog, refr)
    worst = max(range(len(gaps)), key=gaps.__getitem__)
    layer0 = {k: round(g, 6) for k, g in zip(names, gaps)
              if k.startswith("encoder/") and "/layer0/attention/" in k and k.endswith("/kernel")}
    return {"variant": label, "grad_gap": round(gaps[worst], 6), "worst_leaf": names[worst],
            "encoder_layer0_attention": layer0}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    cell = Cell("mellum2_train")
    driver = cell.driver()
    device = torch.device("cuda")
    refr = None
    for variant in args.variants.split(","):
        try:
            names, prog, batches = program_grads(cell, driver, args.seed, device, variant)
        except torch.cuda.OutOfMemoryError as e:
            print(json.dumps({"variant": variant, "error": str(e)[:200]}), flush=True)
            continue
        finally:
            gc.collect()
            torch.cuda.empty_cache()
        if refr is None:
            refr = reference_grads(cell.config, batches, args.seed, names, "float32", device)
            witness = reference_grads(cell.config, batches, args.seed, names,
                                      cell.config["dtype"], device)
            print(json.dumps(report("witness (reference in bf16)", names, witness, refr,
                                    driver.tw.rel_gaps)), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
        print(json.dumps(report(variant, names, prog, refr, driver.tw.rel_gaps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
