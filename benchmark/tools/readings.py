#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card at the cell's own
size, many seeds in one process:

    python3 benchmark/tools/readings.py --workload long_train_fp32 --seeds 11,12,13
    python3 benchmark/tools/readings.py --workload canonical_convert --seeds 11,12 --seconds 3

For each seed one line of JSON: the program's numbers against the float32
reference (as a run compares them), the control's (the reference computed
one precision below the configuration's, fp8 for bf16 and TF32 for
float32, in the program's place) and, for a training cell, the
fault of half the batch left out (the reference on the first half of each
batch, the mean over those rows, in the program's place), and a witness:
the reference at the configuration's own precision in its place. A transfer cell
runs a window of ``--seconds`` at the cell's load first and reads the
control at the positions of the served tokens.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

import torch  # noqa: E402

import transfer  # noqa: E402
from harness import Cell, Context, build_kernels, log  # noqa: E402
from reference import model as ref  # noqa: E402


def train_readings(cell, driver, seed: int, device) -> dict:
    """The program's numbers, and those of the control, a witness and the
    fault of half the batch left out, each in the program's place: its
    stage B followed by the float32 reference from its own state."""
    ctx = Context(cell, seed, 1.0, False, device, time.perf_counter())
    driver.setup(ctx)
    driver.release(ctx)
    gc.collect()
    torch.cuda.empty_cache()
    batches = driver.host_batches(ctx)
    names = ctx.names

    def judged(prog):
        refr = driver.reference_run(ctx.cfg, batches, seed, names, ref.Numerics(), device,
                                    start_b=driver.b_starts(prog))
        out = driver.gaps(prog, refr, names)
        out.pop("left_out")
        return out

    out = {"seed": seed, "program": judged(ctx.prog),
           "rows": [[int(x) for x in b.seq_lens] for b in ctx.feed.handed]}
    dtype = ctx.cfg["dtype"]
    for name, kind in (("control", ref.Numerics.CONTROL[dtype]), ("witness", dtype)):
        out[name] = judged(driver.reference_run(ctx.cfg, batches, seed, names,
                                                ref.Numerics(kind), device))
    half = [{k: v[:len(v) // 2] for k, v in b.items()} for b in batches]
    out["half_batch"] = judged(driver.reference_run(ctx.cfg, half, seed, names, ref.Numerics(),
                                                    device))
    return out


def control_readings(cfg: dict, traffic: dict, picked, midi, device) -> dict:
    """At the positions of the served tokens of ``picked``: the widest and
    the mean gap below the reference's best of the token that the fp8
    control puts first, the same for a bf16 witness, and at the program's
    widest gap how far the witness ranks the served token below its own
    best."""
    p = transfer.shipped_params(cfg, device)
    out = {"control_gap": 0.0, "witness_gap": 0.0, "worst": None}
    sums, n, widest = {"control": 0.0, "witness": 0.0}, 0, 0.0
    with ref.no_tf32():
        for rid, b, i, c, _, source, row, last in transfer.served_rows(picked, traffic, midi,
                                                                       device):
            if last < 1:
                continue
            lg, served = transfer.perturbed_logits(p, cfg, b, i, c, source, row, last,
                                                   ref.Numerics())
            best = lg.max(-1).values
            gaps = best - lg.gather(1, served[:, None])[:, 0]
            n += last
            lw = None
            for kind, name in (("fp8", "control"), ("bfloat16", "witness")):
                lc, _ = transfer.perturbed_logits(p, cfg, b, i, c, source, row, last,
                                                  ref.Numerics(kind))
                lw = lc if name == "witness" else lw
                cg = best - lg.gather(1, lc.argmax(-1)[:, None])[:, 0]
                out[f"{name}_gap"] = max(out[f"{name}_gap"], float(cg.max()))
                sums[name] += float(cg.sum())
            if float(gaps.max()) > widest:
                widest = float(gaps.max())
                t = int(gaps.argmax())
                out["worst"] = {"request": rid, "class": c, "step": t + 1, "row_len": last,
                                "gap": widest, "witness_gap": float(lw[t].max() - lw[t, served[t]])}
    for name in sums:
        out[f"{name}_gap_mean"] = sums[name] / max(1, n)
    return out


def transfer_readings(cell, driver, seed: int, seconds: float, device) -> dict:
    ctx = Context(cell, seed, seconds, False, device, time.perf_counter())
    driver.setup(ctx)
    driver.window(ctx)
    driver.release(ctx)
    picked = transfer.sample(ctx.results, ctx.window_batches, seed, ctx.traffic["check_tokens"])
    found = transfer.compare(ctx.cfg, ctx.traffic, picked, ctx.midi, ctx.results, device)
    found.update(control_readings(ctx.cfg, ctx.traffic, picked, ctx.midi, device))
    return {"seed": seed, "program": found, "e2e": ctx.e2e}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                    help="run the program at a changed configuration key (a witness: "
                         "dtype=\"float32\", use_flash_attention=false)")
    args = ap.parse_args()
    cell = Cell(args.workload)
    for kv in args.set:
        key, value = kv.split("=", 1)
        cell.config = dict(cell.config, **{key: json.loads(value)})
    driver = cell.driver()
    device = torch.device("cuda")
    build_kernels(cell.workload["kernels"])
    for seed in (int(s) for s in args.seeds.split(",")):
        if cell.traffic["driver"] == "train_window":
            out = train_readings(cell, driver, seed, device)
        else:
            out = transfer_readings(cell, driver, seed, args.seconds, device)
        log("readings " + json.dumps(out))
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
