"""BENCHMARK.json keeps to the benchmark's contract, and a run's last line
has the keys and types the contract names, the numbers compared last."""

import json
import re

import pytest

from helpers import BENCH, harness, run_cpu

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def test_benchmark_json_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {w["name"]: w for w in SPEC["workloads"]}
    configs = {c["name"]: c for c in SPEC["configs"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for c in SPEC["configs"]:
        assert json.loads((BENCH.parent / c["file"]).read_text())["name"] == c["name"]
        assert c["reduced"] == [] and len(c["source"]) <= 200
    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        cell = harness.Cell(w["name"])
        reported = [m["name"] for m in cell.end_to_end]
        assert reported[0] == "setup_s" and len(reported) >= 2 and cell.per_layer
        assert (BENCH / "drivers" / f"{cell.traffic['driver']}.py").exists()


@pytest.fixture(scope="module")
def convert_run():
    return run_cpu("canonical_convert", seed=2**31 + 77, seconds=0.5)


def test_result_line(convert_run):
    result, ctx = convert_run
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "note_events_per_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}


def test_same_seed_same_inputs():
    import numpy as np
    from drivers.train_window import Feed

    rows = {"tokens": np.arange(200).reshape(40, 5), "seq_lens": np.full(40, 5),
            "labels": np.arange(200).reshape(40, 5)}
    classes = np.arange(40) % 2

    def epoch(seed):
        it = iter(Feed(rows, classes, 8, seed, 0))
        return [next(it).tokens[:, 0] // 5 for _ in range(5)]

    a, b, c = epoch(2**33 + 1), epoch(2**33 + 1), epoch(2**33 + 2)
    assert all((x == y).all() for x, y in zip(a, b))
    assert not all((x == y).all() for x, y in zip(a, c))
    # every seed hands out every row once an epoch, in another order
    assert sorted(np.concatenate(a)) == sorted(np.concatenate(c)) == list(range(40))
