"""The span and counter metrics on a traced run on the CPU at the small
size the other tests use: the line carries each of them, finite, and
keeps its schema; no climb graph is captured on the CPU."""

import math

import run
from test_portbench_schema import check_line

NEW = ("unstepped_s", "bubble_pack_s", "climb_capture_s", "climb_lane_use",
       "device_readbacks")


def test_a_traced_cpu_run_reports_the_span_and_counter_metrics(
        monkeypatch):
    from flye_tpu_torch import main

    def skip_the_warm_up():
        # on the CPU the warm-up job builds nothing the window needs
        calls = []
        orig = main.main

        def main_(argv):
            calls.append(argv)
            return 0 if len(calls) == 1 else orig(argv)
        monkeypatch.setattr(main, "main", main_)
    args = run.parse(["--workload", "pbraw50-asm", "--seed",
                      "3000000029", "--seconds", "1", "--trace", "1"])
    res, lines = run.run_cell(
        args, require_card=False, device="cpu", patch=skip_the_warm_up,
        overrides={"config": {"genome_length": 12_000},
                   "cell": {"must": [], "limits": {"k1_diff": 0},
                            "jobs": 1}})
    check_line(res, 1, "pbraw50-asm")
    assert res["correct"], lines
    metrics = res["metrics"]
    assert set(NEW) <= set(metrics)
    assert all(math.isfinite(metrics[n]["value"]) for n in NEW)
    assert metrics["climb_capture_s"]["value"] == 0.0
    assert metrics["device_readbacks"]["value"] == 0.0
    assert 0 < metrics["climb_lane_use"]["value"] <= 100
    # the job's time that no step covers is a part of its wall
    wall = res["jobs"][0]["wall_s"]
    assert 0 < metrics["unstepped_s"]["value"] < wall
