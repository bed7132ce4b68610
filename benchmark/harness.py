"""What every cell shares: finding a cell's files by name, the harness's
spans, the traced window, the device's numbers and the result line.

A cell named in ``BENCHMARK.json`` is found through its files:
``configs/<config>.json`` (widths, recipe, source), ``traffic/<traffic>.json``
(the driver that generates the load, and its parameters),
``workloads/<cell>.json`` (the kernel sources the cell builds, the limits of
its correctness check) and ``metrics/<metric>.py`` (one reader a per-layer
metric). A later cell, configuration, traffic mix or metric is new files.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "musicstyletransfer_tpu")
KERNEL_GAP_NS = 5000  # shorter idle gaps are one kernel's launch after another's


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A Python file of the benchmark as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` in BENCHMARK.json and everything its name
    leads to."""

    def __init__(self, name: str):
        bench = load_json(ROOT / "BENCHMARK.json")
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise SystemExit(f"no cell {name!r} in BENCHMARK.json ({sorted(entries)})")
        self.entry = entries[name]
        self.name = name
        self.config = load_json(BENCH / "configs" / f"{self.entry['config']}.json")
        self.traffic = load_json(BENCH / "traffic" / f"{self.entry['traffic']}.json")
        self.workload = load_json(BENCH / "workloads" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and any(e["name"] == m["moves"] for e in self.end_to_end)]

    def driver(self):
        kind = self.traffic["driver"]
        return load_module(BENCH / "drivers" / f"{kind}.py", f"driver_{kind}")

    @staticmethod
    def reader(metric: str):
        return load_module(BENCH / "metrics" / f"{metric}.py", f"metric_{metric}")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Spans:
    """The harness's spans around its calls into each layer: seconds and
    calls by name, and while a trace runs each span's interval (wall-clock
    ns, the profiler's clock), so idle gaps can be named by what the host
    was doing, on whichever thread."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self.intervals: List[tuple] = []  # (name, start_ns, end_ns) while tracing
        self.tracing = False
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name: str):
        tracing = self.tracing
        t0, t0_ns = time.perf_counter(), time.time_ns()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.seconds[name] = self.seconds.get(name, 0.0) + dt
                self.calls[name] = self.calls.get(name, 0) + 1
                if tracing:
                    self.intervals.append((name, t0_ns, time.time_ns()))


class Trace:
    """A profiled stretch of the window: the device's operations and the
    harness's spans on one clock."""

    def __init__(self):
        self.ops: List[tuple] = []  # (name, start_ns, duration_ns) of device operations
        self.spans: List[tuple] = []  # (name, start_ns, end_ns) of the harness's spans
        self.window_s = 0.0
        self.start_ns = 0
        self.end_ns = 0

    @contextlib.contextmanager
    def record(self, spans: Spans):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        spans.tracing = True
        t0 = time.perf_counter()
        t0_ns = time.time_ns()
        try:
            yield self
        finally:
            torch.cuda.synchronize()
            self.window_s = time.perf_counter() - t0
            t1_ns = time.time_ns()
            spans.tracing = False
            prof.stop()
        self._read(prof, t0_ns, t1_ns)
        self.spans = list(spans.intervals)

    def _read(self, prof, t0_ns: int, t1_ns: int) -> None:
        """The profiler's events (wall-clock nanoseconds since the epoch,
        the clock of ``time.time_ns``)."""
        for e in prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA"):
                self.ops.append((e.name(), e.start_ns(), e.duration_ns()))
        self.start_ns, self.end_ns = t0_ns, t1_ns

    def kernels(self) -> List[tuple]:
        """Device kernels (no copies or fills)."""
        return [o for o in self.ops if not o[0].startswith(("Memcpy", "Memset"))]

    def busy_intervals(self) -> List[tuple]:
        """The union of the device operations' intervals, sorted."""
        iv = sorted((s, s + d) for _, s, d in self.ops)
        out: List[list] = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, _, d in self.ops:
            by[name] = by.get(name, 0.0) + d / 1e9
        return [[n[:120], s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Seconds the device sat idle, summed by the innermost harness span
        any thread of the host was in at each gap's middle ("none" outside
        every span)."""
        busy = self.busy_intervals()
        if not busy:
            return []
        edges = [(self.start_ns, busy[0][0])] + [(busy[i][1], busy[i + 1][0])
                                                 for i in range(len(busy) - 1)]
        edges.append((busy[-1][1], max(busy[-1][1], self.end_ns)))
        spans = sorted(self.spans, key=lambda s: s[2] - s[1])  # innermost first
        by: Dict[str, float] = {}
        for s, e in edges:
            if e <= s:
                continue
            mid = (s + e) // 2
            name = ("kernel_to_kernel" if e - s < KERNEL_GAP_NS
                    else next((n for n, a, b in spans if a <= mid <= b), "none"))
            by[name] = by.get(name, 0.0) + (e - s) / 1e9
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def sync(device) -> None:
    """Wait for ``device`` (a no-op on the CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card() -> dict:
    """The card's name, count and power limit."""
    import torch

    out = {"kind": torch.cuda.get_device_name(0), "power_limit": "not read"}
    try:
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        pass
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def build_kernels(names: List[str]) -> None:
    """Build the program's kernel sources the cell runs, all at once (each
    build is the program's own, into its build directory in the checkout;
    a source already built is found there)."""
    if not names:
        return
    from musicstyletransfer_torch.ops import _build

    errors: List[BaseException] = []

    def one(n):
        try:
            _build.build(n)
        except BaseException as exc:  # raised below
            errors.append(exc)

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


class Context:
    """One run of one cell: what a driver reads (the cell's files, seed,
    device) and what it leaves for the result (end-to-end values, work
    counts, checks)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float):
        self.cell, self.cfg, self.traffic = cell, cell.config, cell.traffic
        self.limits = cell.workload["limits"]
        self.seed, self.trace_on, self.device, self.t0 = seed, trace, device, t0
        self.seconds = min(seconds, self.traffic["trace_seconds"]) if trace else seconds
        self.spans = Spans()
        self.phases: Dict[str, float] = {}
        self.setup_s = None
        self.trace: Optional[Trace] = None
        self.e2e: Dict[str, float] = {}
        self.work: Dict[str, float] = {}
        self.checks: List[tuple] = []  # (name, value, limit, holds)
        self.attempted = 0
        self.failed = 0
        self.memory_peak = 0
        self.gc_pauses: List[float] = []  # seconds of each collection in the window

    @contextlib.contextmanager
    def phase(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t

    @contextlib.contextmanager
    def measured(self):
        """The measured window: set-up ends on entry, its objects moved out
        of the collector's way (``gc.freeze``: a full collection in the
        window then scans only what the window made), and each collection
        in the window timed; with ``trace`` the whole window is profiled."""
        gc.collect()
        gc.freeze()
        self.setup_s = time.perf_counter() - self.t0
        started = []

        def timed(phase, info):
            if phase == "start":
                started.append(time.perf_counter())
            elif started:
                self.gc_pauses.append(time.perf_counter() - started.pop())

        gc.callbacks.append(timed)
        try:
            if self.trace_on and self.device.type == "cuda":
                self.trace = Trace()
                with self.trace.record(self.spans):
                    yield
            else:
                yield
        finally:
            gc.callbacks.remove(timed)

    def read_memory_peak(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.memory_peak = int(torch.cuda.max_memory_allocated(self.device))
