"""Small configurations and runs of the cells on the CPU for the tests."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402
import run  # noqa: E402


def tiny_config(cell: str, dtype: str = None) -> dict:
    """The cell's configuration at widths a CPU test can hold (at another
    compute ``dtype`` where one is given)."""
    cfg = copy.deepcopy(harness.Cell(cell).config)
    cfg["dtype"] = dtype or cfg["dtype"]
    cfg["encoder"].update(model_size=32, num_heads=4)
    cfg["decoder"].update(model_size=16, num_heads=4)
    cfg["latent_dim"] = 8
    cfg["train"].update(batch_size=4, max_seq_len=24, steps_per_dispatch=2)
    return cfg


def run_cpu(cell: str, seed: int = 5, seconds: float = 0.5, trace: bool = False,
            config=None, traffic=None):
    """One run of ``cell`` on the CPU: (result, context)."""
    r = run.run_cell(cell, seed, seconds, trace, device="cpu", config=config, traffic=traffic)
    return r, r.pop("_ctx")
