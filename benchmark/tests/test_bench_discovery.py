"""A cell, a configuration, a traffic mix and a per-layer metric are found
by their names alone: added as new files, they need no edit of any file
the benchmark has."""

import json
import shutil
import subprocess
import sys

from helpers import BENCH

PROBE = r"""
import json, sys
sys.path.insert(0, ".")
import harness
cell = harness.Cell("dummy_cell")
print(json.dumps({"config": cell.config["name"], "driver": cell.traffic["driver"],
                  "limits": cell.workload["limits"], "e2e": [m["name"] for m in cell.end_to_end],
                  "per_layer": [m["name"] for m in cell.per_layer],
                  "read": harness.Cell.reader("dummy_metric").read(None)}))
"""


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    before = {p.relative_to(root): p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "vae_canonical.json").read_text())
    cfg["name"] = "dummy_config"
    (b / "configs" / "dummy_config.json").write_text(json.dumps(cfg))
    (b / "traffic" / "dummy_traffic.json").write_text(json.dumps(
        {"driver": "backlog", "data": "work/data/guitar_bass", "max_seq_len": 64}))
    (b / "workloads" / "dummy_cell.json").write_text(json.dumps(
        {"kernels": [], "limits": {"logit_gap": 0.5}}))
    (b / "metrics" / "dummy_metric.py").write_text("def read(ctx):\n    return 42.0\n")
    bench["configs"].append({"name": "dummy_config", "source": "https://example.org/dummy",
                             "file": "benchmark/configs/dummy_config.json", "reduced": [],
                             "why": "a dummy"})
    bench["workloads"].append({"name": "dummy_cell", "config": "dummy_config",
                               "traffic": "dummy_traffic", "chips": 1, "why": "a dummy"})
    bench["end_to_end"][-1]["workloads"].append("dummy_cell")
    bench["per_layer"].append({"name": "dummy_metric", "unit": "%", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": bench["end_to_end"][-1]["name"],
                               "workloads": ["dummy_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=b, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    found = json.loads(out.stdout.strip().splitlines()[-1])
    assert found == {"config": "dummy_config", "driver": "backlog", "limits": {"logit_gap": 0.5},
                     "e2e": ["setup_s", bench["end_to_end"][-1]["name"]],
                     "per_layer": ["dummy_metric"], "read": 42.0}
    after = {p.relative_to(root): p.read_bytes() for p in (root / "benchmark").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())  # nothing that was there changed
