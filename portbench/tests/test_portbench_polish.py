"""The standalone-polisher cell `hifi30-polish`: its entry, a run on the
CPU at a small size (the look for a card skipped), the fault that must
fail it and the share of the climb K4 scores.  On the card (`gpu`
marker; skips without one): a traced run of the cell through
`run.run_cell`, every job launching K4, with the metric the cell
lists.

Every test that writes FLYE_TPU_FUSED (the entry sets it) first hands
it to monkeypatch, which restores it, so no later test in the process
runs with K4 selected."""

import math
import os

import numpy as np
import pytest

import gen
import run
from test_portbench_schema import check_line

CELL = "hifi30-polish"
GLEN = 20_000


def cell_files():
    cell = run.read_json(run.HERE, "workloads", f"{CELL}.json")
    config = run.read_json(run.HERE, "configs", f"{cell['config']}.json")
    traffic = run.read_json(run.HERE, "traffic", f"{cell['traffic']}.json")
    return cell, config, traffic


def test_entry_writes_the_draft_and_selects_k4(tmp_path, monkeypatch):
    monkeypatch.delenv("FLYE_TPU_FUSED", raising=False)
    _, config, traffic = cell_files()
    entry = run.load("entries", traffic["entry"])
    config = dict(config, genome_length=GLEN)
    genome, reads = gen.make_job(7, 0, config)
    argv, output, n = entry.prepare(str(tmp_path), genome, reads, config,
                                    traffic, gen.rng_for(7, 0, "draft"))
    assert os.environ["FLYE_TPU_FUSED"] == "1"
    assert n == sum(len(r) for _, r in reads)
    draft = gen.read_fasta(str(tmp_path / "draft.fasta"))
    assert len(draft) == 1
    # 1% errors, ins 0.5 and del 0.3 of them: the draft is ~0.2% longer
    assert abs(len(draft[0][1]) - GLEN * 1.002) < 0.002 * GLEN
    assert not np.array_equal(draft[0][1][:1000], genome[:1000])
    assert argv[:2] == ["--polish-target", str(tmp_path / "draft.fasta")]
    assert argv[2:4] == ["--pacbio-hifi", str(tmp_path / "reads.fasta")]
    assert argv[argv.index("-i") + 1] == "1"
    assert output == str(tmp_path / "out" / "polished_1.fasta")
    # the same job draws the same draft
    again = gen.apply_errors(genome, config["draft"]["error_rate"],
                             config["draft"]["error_mix"],
                             gen.rng_for(7, 0, "draft"))
    assert np.array_equal(again, draft[0][1])


def unchanged(orig):
    def climb(cand, cand_len, branches, blen, bmask, subs, max_iters,
              eps=None):
        n = len(cand_len)
        return (np.array(cand, np.uint8), np.array(cand_len, np.int32),
                np.zeros(n, np.float32), np.zeros(n, np.int32))
    return climb


def run_small(monkeypatch, trace=0, patch=None):
    """One run of the cell on the CPU at GLEN, its limits as they are,
    every K1 launch sampled; the warm-up job returns at once (on the CPU
    it builds nothing the window needs).  On the CPU the polisher climbs
    with the native climber, which the "climb" hook does not see."""
    from flye_tpu_torch import main
    monkeypatch.delenv("FLYE_TPU_FUSED", raising=False)

    def patches():
        if patch is not None:
            patch()
        calls = []
        orig = main.main

        def main_(argv):
            calls.append(argv)
            return 0 if len(calls) == 1 else orig(argv)
        monkeypatch.setattr(main, "main", main_)
    args = run.parse(["--workload", CELL, "--seed", "3000000031",
                      "--seconds", "1", "--trace", str(trace)])
    return run.run_cell(
        args, require_card=False, device="cpu", patch=patches,
        overrides={"config": {"genome_length": GLEN},
                   "cell": {"must": ["chain_dp"], "jobs": 1,
                            "sample": {"chain_dp": [1.0, 4]}}})


@pytest.mark.parametrize("trace", [0, 1])
def test_a_small_cpu_run_is_correct(trace, monkeypatch):
    res, lines = run_small(monkeypatch, trace)
    check_line(res, trace, CELL)
    assert res["correct"] is True, lines
    assert res["attempted"] == 1 and res["failed"] == 0
    checks = res["checks"]
    assert set(checks) == {"err_ppm_max", "err_window_share",
                           "uncovered_share", "k1_diff"}
    assert checks["err_ppm_max"]["value"] < checks["err_ppm_max"]["limit"]
    if trace:
        # no resident climb on the CPU: K4's share has nothing to read
        assert res["metrics"] == {}
    else:
        assert set(res["metrics"]) == {"read_mbp_s", "qv",
                                       "peak_device_gib", "setup_s"}
        assert all(math.isfinite(m["value"]) for m in
                   res["metrics"].values())


def test_an_unchanged_climb_is_not_correct(monkeypatch):
    from flye_tpu_torch.ops import polish

    def patch():
        monkeypatch.setattr(polish, "_polish_bubbles_native",
                            unchanged(polish._polish_bubbles_native))
    res, lines = run_small(monkeypatch, patch=patch)
    assert res["correct"] is False, lines
    checks = res["checks"]
    assert "err_ppm_max" in checks["failed"], lines
    # the output is about the draft: ~1% errors
    assert checks["err_ppm_max"]["value"] > 5 * checks["err_ppm_max"][
        "limit"]


class Run:
    def __init__(self, n_jobs):
        self.jobs = [{"output": f"/x/{i}/polished_1.fasta"}
                     for i in range(n_jobs)]


@pytest.mark.parametrize("counters,share", [
    ([{"climb.lane_steps": 100, "climb.fused_lane_steps": 80},
      {"climb.lane_steps": 300, "climb.fused_lane_steps": 300}], 95.0),
    ([{"climb.lane_steps": 100, "climb.fused_lane_steps": 0}], 0.0),
    # a program that keeps no such counter, or no resident climb
    ([{"climb.lane_steps": 100}], None),
    ([{"climb.lane_steps": 0, "climb.fused_lane_steps": 0}], None)])
def test_fused_lane_share_reads_the_counters(counters, share, monkeypatch):
    import jobrecords
    recs = [{"counters": c} for c in counters]
    monkeypatch.setattr(jobrecords, "records", lambda run: recs)
    got = run.load("metrics", "fused_lane_share").read(Run(len(recs)))
    assert got == (None if share is None else pytest.approx(share))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_a_traced_run_on_the_card_launches_k4_in_every_job(card,
                                                           monkeypatch):
    from flye_tpu_torch.utils import trace
    monkeypatch.delenv("FLYE_TPU_FUSED", raising=False)
    args = run.parse(["--workload", CELL, "--seed", "4100000017",
                      "--seconds", "51", "--trace", "1"])
    res, lines = run.run_cell(args)
    assert res["correct"], lines
    assert res["device"]["platform"] == "gpu"
    jobs = list(trace._records)[-res["attempted"]:]
    assert all(r["launches"].get("polish_fused", 0) > 0 for r in jobs)
    want = {m["name"] for m in run.read_json(run.ROOT, "BENCHMARK.json")[
        "per_layer"] if CELL in m.get("workloads", [CELL])}
    assert set(res["metrics"]) == want == {"fused_lane_share"}
    assert 0 < res["metrics"]["fused_lane_share"]["value"] <= 100
