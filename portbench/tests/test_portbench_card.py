"""On the card: a run of a cell through the command, untraced and
traced, comes out correct, on the GPU, with every metric the cell
lists.  Skips without a CUDA card (decided in a fixture).  Run on the
card's machine with

    python -m pytest -o addopts="" -m gpu portbench/tests/test_portbench_card.py
"""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def run_cell(cell, seed, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "51", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_is_correct_on_the_card(card, trace):
    cell = "pbraw50-asm"
    res = run_cell(cell, 4100000000 + trace, trace)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["memory_peak_bytes"] > 0
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    want = {m["name"] for m in
            bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want
    if trace:
        assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
        for m in ("roofline.chain_dp", "roofline.polish_pair"):
            assert 0 < res["metrics"][m]["value"] <= 100
