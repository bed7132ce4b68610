"""On a card: one short run of every cell, each correct with its numbers.
Skips where there is no card (decided inside the fixture)."""

import json
import subprocess
import sys

import pytest

from helpers import BENCH

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_runs_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(2**31 + 99), "--seconds", "2", "--trace", "0"],
                         cwd=BENCH.parent, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", out.stderr[-4000:]
