#!/usr/bin/env python3
"""The readings the Mellum2 cell's limits are set from, on the card at the
cell's own size, many seeds in one process:

    python3 benchmark/tools/readings_mellum2.py --seeds 11,12,13

``tools/readings.py``'s training readings through the cell's own driver
(``drivers/train_window_mellum2.py``), one line of JSON a seed on standard
output: the program's numbers against the float32 reference, and those of
the fp8 control, the bf16 witness and half the batch, each in the
program's place. Each of them runs stage A from the seeded weights and each
group of stage B from the program's own state at its start, as the
reference does: one state held on the host a group (20 GB at 1.69B
parameters and Adam's moments), where ``tools/readings.py`` holds each
stand-in's own states as well, which the host has no room for.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

import time  # noqa: E402

import torch  # noqa: E402

from harness import Cell, Context  # noqa: E402
from reference.model import Numerics  # noqa: E402


def train_readings(cell, driver, seed: int, device) -> dict:
    ctx = Context(cell, seed, 1.0, False, device, time.perf_counter())
    driver.setup(ctx)
    driver.release(ctx)
    gc.collect()
    torch.cuda.empty_cache()
    batches, names, starts = driver.host_batches(ctx), ctx.names, driver.b_starts(ctx.prog)

    def run(kind, rows=None):
        b = batches if rows is None else [{k: v[:rows] for k, v in x.items()} for x in batches]
        return driver.reference_run(ctx.cfg, b, seed, names, Numerics(kind), device,
                                    start_b=starts)

    def judged(prog, refr):
        out = driver.gaps(prog, refr, names)
        out.pop("left_out")
        return out

    refr = run("float32")
    out = {"seed": seed, "program": judged(ctx.prog, refr),
           "rows": [[int(x) for x in b.seq_lens] for b in ctx.feed.handed]}
    dtype = ctx.cfg["dtype"]
    for name, kind in (("control", Numerics.CONTROL[dtype]), ("witness", dtype)):
        out[name] = judged(run(kind), refr)
    out["half_batch"] = judged(run("float32", len(batches[0]["tokens"]) // 2), refr)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    cell = Cell("mellum2_train")
    driver = cell.driver()
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(train_readings(cell, driver, seed, device)), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
