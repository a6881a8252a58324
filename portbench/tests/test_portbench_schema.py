"""BENCHMARK.json against the contract's schema, the cell files against
it, and the last line's schema on a run made on the CPU at a small
size (the look for a card skipped)."""

import json
import math
import os
import re

import pytest

import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return run.read_json(run.ROOT, "BENCHMARK.json")


def test_benchmark_json_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert {"read_mbp_s", "qv", "peak_device_gib", "setup_s"} <= e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert os.path.exists(os.path.join(run.HERE, "metrics",
                                           m["name"] + ".py"))


def test_cells_match_their_files():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        cell = run.read_json(run.HERE, "workloads", w["name"] + ".json")
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        conf = run.read_json(run.ROOT, configs[w["config"]]["file"])
        assert sorted(conf["reduced"]) == sorted(
            configs[w["config"]]["reduced"])
        assert len(configs[w["config"]]["source"]) <= 200
        traffic = run.read_json(run.HERE, "traffic",
                                cell["traffic"] + ".json")
        assert os.path.exists(os.path.join(run.HERE, "entries",
                                           traffic["entry"] + ".py"))
        assert set(cell["limits"]) >= {"k1_diff", "climb_gap"}
        assert cell["jobs"] >= 1 and isinstance(cell["pool_seed"], int)


def check_line(res, trace, cell):
    b = bench()
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert list(res)[-1] == "checks"
    want = b["per_layer"] if trace else b["end_to_end"]
    mine = {m["name"] for m in want if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) <= mine
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        br = res["breakdown"]
        assert len(br["device_ops"]) <= 10 and len(br["idle_gaps"]) <= 10
    for v in res["checks"].values():
        if isinstance(v, dict):
            assert set(v) == {"value", "limit"}
    json.dumps(res)


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_schema_on_a_small_cpu_run(trace):
    args = run.parse(["--workload", "pbraw50-asm", "--seed",
                      "3000000019", "--seconds", "1", "--trace",
                      str(trace)])
    # the schema only: at 12 kb on the CPU the truth reads are not the
    # cell's (its limits hold at its own size on the card), so the test
    # keeps the exact kernel limits and no truth limit
    res, lines = run.run_cell(
        args, require_card=False, device="cpu",
        overrides={"config": {"genome_length": 12_000},
                   "cell": {"must": [], "limits": {"k1_diff": 0},
                            "jobs": 1}})
    check_line(res, trace, "pbraw50-asm")
    assert res["attempted"] == 1 and res["failed"] == 0
    assert res["correct"], lines
    if not trace:
        assert set(res["metrics"]) == {"read_mbp_s", "qv",
                                       "peak_device_gib", "setup_s"}
    else:
        # on the CPU no kernel runs: the rooflines have nothing to read
        assert set(res["metrics"]) == {
            "assembly_s", "overlap_s", "polisher_s", "bubble_kernels_s",
            "repeat_s", "device_idle_share"}
    assert all(ln.startswith("check ") for ln in lines)
