"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's)."""

import subprocess
import sys

from helpers import BENCH, harness

RUN_A_CELL = r"""
import sys
sys.path.insert(0, "benchmark/tests")
from helpers import run_cpu, harness
result, ctx = run_cpu("canonical_convert", seed=3, seconds=0.2)
assert result["correct"], result
import musicstyletransfer_torch
print("FORBIDDEN", harness.forbidden_modules())
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", RUN_A_CELL], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "FORBIDDEN []"


def test_whole_names_are_compared(monkeypatch):
    for name in ("musicstyletransfer_torch_x", "jaxtyping", "flaxen.core"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "musicstyletransfer_tpu.midi", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert harness.forbidden_modules() == ["jax", "musicstyletransfer_tpu"]
