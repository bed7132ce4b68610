#!/usr/bin/env python3
"""Run one cell of the benchmark once, on one CUDA card:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in BENCHMARK.json; its configuration,
traffic mix, limits and per-layer metrics are found by name
(``harness.Cell``). Set-up (builds, imports, inputs, weights, warm-up) is
timed as ``setup_s``; then the window measures for ``--seconds`` (with
``--trace 1`` the traffic's ``trace_seconds``, under the profiler, and the
per-layer metrics are reported instead of the end-to-end ones); then what
the window produced is held against the plain reference. The last lines
on standard error are the numbers compared, each with its limit, and the
last line on standard output is the result as one JSON object. No card,
fewer cards than the cell asks for, or JAX or the JAX package loaded once
the window has closed: exit code 2 and no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from harness import Cell, Context, build_kernels, card, forbidden_modules, log  # noqa: E402


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None, config=None,
             traffic=None) -> dict:
    """One run of cell ``name``: the result object (without printing it).
    ``device`` defaults to CUDA; ``config``/``traffic`` override the cell's
    files (the CPU tests' small sizes)."""
    import torch

    device = torch.device(device or "cuda")
    cell = Cell(name)
    if config is not None:
        cell.config = config
    if traffic is not None:
        cell.traffic = traffic
    ctx = Context(cell, seed, seconds, trace, device, T0)
    driver = cell.driver()
    # A program that does not build or set up gives no run: that exception
    # ends the process. From the window on, a failure is a run not correct.
    if device.type == "cuda":
        with ctx.phase("build"):
            build_kernels(cell.workload["kernels"])
    driver.setup(ctx)
    error = None
    try:
        driver.window(ctx)
        ctx.read_memory_peak()
        driver.release(ctx)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        driver.check(ctx)
    except Exception:  # the run is not correct; the traceback goes to stderr
        error = traceback.format_exc()
        log(error)
    checks = ctx.checks
    correct = error is None and bool(checks) and all(ok for *_, ok in checks)
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            v = ctx.setup_s if m["name"] == "setup_s" else ctx.e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = Cell.reader(m["name"]).read(ctx) if error is None else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0) if device.type == "cuda"
           else "cpu", "count": 1, "memory_peak_bytes": ctx.memory_peak}
    result = {"correct": correct, "attempted": ctx.attempted, "failed": ctx.failed,
              "metrics": metrics, "device": dev}
    if ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s()
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.device_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim, _ in checks}
    ctx.result_checks = checks
    result["_ctx"] = ctx
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    chips = Cell(args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA card(s); torch.cuda.is_available() "
            f"{torch.cuda.is_available()}, {torch.cuda.device_count()} card(s)")
        return 2
    info = card()
    log(f"card: {info['kind']}, power limit {info['power_limit']}; torch {torch.__version__}")
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    ctx = result.pop("_ctx")
    for k, v in sorted(ctx.phases.items()):
        log(f"setup phase {k}: {v:.3f} s")
    if ctx.setup_s is not None:
        log(f"setup_s {ctx.setup_s:.3f} (phases above; the rest is imports and inputs)")
    g = ctx.gc_pauses
    log(f"collections in the window: {len(g)}, {sum(g):.4f} s, the longest "
        f"{max(g, default=0.0) * 1e3:.2f} ms")
    for k in sorted(ctx.spans.seconds):
        log(f"span {k}: {ctx.spans.seconds[k]:.4f} s in {ctx.spans.calls[k]} calls")
    bad = forbidden_modules()
    if bad:
        log(f"loaded modules that must not be: {bad}")
        return 2
    log(json.dumps({k: result[k] for k in ("attempted", "failed", "metrics")}))
    for name, value, limit, ok in ctx.result_checks:
        log(f"check {name}: {value} (limit {limit}) {'ok' if ok else 'FAILED'}")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
