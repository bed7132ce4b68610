#!/usr/bin/env python3
"""The device's idle time in one traced run of a cell, named by the
program's own spans:

    python3 benchmark/tools/idle_by_span.py --workload canonical_convert --seed 11

Runs the cell once as ``--trace 1`` does (``run.run_cell``) and prints one
line of JSON: the idle seconds split by overlap, each instant of a gap to the
innermost (shortest) program span (``musicstyletransfer_torch.tracing``)
that any thread of the host had open then ("none" outside every span; gaps
under 5 us are ``kernel_to_kernel``, as in ``harness.Trace.idle_gaps``); the
seconds and count of each program span in the window, and of each of the
harness's, which the program's lie within; the window's files or steps, the
end-to-end rate it read, the per-layer metrics and the device's operations
by time. Once ``Trace.idle_gaps`` names program spans too, the ledger's
breakdown gives this split and the tool goes.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

import program_spans  # noqa: E402
import run  # noqa: E402
from harness import KERNEL_GAP_NS, card  # noqa: E402


def totals(spans) -> dict:
    """{name: [seconds, count]} of (name, start_ns, end_ns) spans."""
    out: dict = {}
    for name, a, b in spans:
        s = out.setdefault(name, [0.0, 0])
        s[0] += (b - a) / 1e9
        s[1] += 1
    return out


def innermost_pieces(spans) -> list:
    """[(start_ns, end_ns, name)]: the timeline cut at every span's edges,
    each piece named by the shortest span that covers it ("none" where
    none does)."""
    edges = sorted({t for _, a, b in spans for t in (a, b)})
    by_start = sorted(spans, key=lambda s: s[1])
    out, active, i = [], [], 0
    for a, b in zip(edges, edges[1:]):
        while i < len(by_start) and by_start[i][1] <= a:
            active.append(by_start[i])
            i += 1
        active = [s for s in active if s[2] > a]
        out.append((a, b, min(active, key=lambda s: s[2] - s[1])[0] if active else "none"))
    return out


def idle_by_overlap(trace, spans) -> list:
    """Idle seconds by the innermost span open at each instant of each gap
    (gaps under ``KERNEL_GAP_NS`` are ``kernel_to_kernel``), largest first."""
    busy = trace.busy_intervals()
    if not busy:
        return []
    gaps = [(trace.start_ns, busy[0][0])] + [(busy[i][1], busy[i + 1][0])
                                             for i in range(len(busy) - 1)]
    gaps.append((busy[-1][1], max(busy[-1][1], trace.end_ns)))
    pieces = innermost_pieces(spans)
    starts = [p[0] for p in pieces]
    by: dict = {}
    for s, e in gaps:
        if e <= s:
            continue
        if e - s < KERNEL_GAP_NS:
            by["kernel_to_kernel"] = by.get("kernel_to_kernel", 0) + (e - s)
            continue
        covered = 0
        k = max(0, bisect.bisect_right(starts, s) - 1)
        while k < len(pieces) and pieces[k][0] < e:
            a, b, name = pieces[k]
            o = min(b, e) - max(a, s)
            if o > 0:
                by[name] = by.get(name, 0) + o
                covered += o
            k += 1
        if e - s > covered:
            by["none"] = by.get("none", 0) + (e - s - covered)
    return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    args = ap.parse_args()
    result = run.run_cell(args.workload, args.seed, args.seconds, True)
    ctx = result.pop("_ctx")
    trace = ctx.trace
    program = program_spans.recorded(ctx) or []
    out = {"workload": args.workload, "seed": args.seed, "card": card(),
           "correct": result["correct"], "window_s": trace.window_s, "busy_s": trace.busy_s(),
           "idle_by_program_span": idle_by_overlap(trace, program),
           "program_spans": totals(program), "harness_spans": totals(trace.spans),
           "attempted": ctx.attempted, "steps": ctx.work.get("steps"), "e2e": ctx.e2e,
           "metrics": result["metrics"], "device_ops": result["breakdown"]["device_ops"]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
