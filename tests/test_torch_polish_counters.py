"""The climb's counters in the job record, and the standalone polisher's
record: `climb.fused_lane_steps` counts the lane steps of the batches
whose route is K4's ("polish_fused"), beside `climb.lane_steps`.

On the CPU a `_Climb` scores with the plain version whatever its route
(K4's plain version is K2+K3's), so one climb run on each route gives
identical outputs and differs in the counter alone."""

import numpy as np
import pytest
import torch

from flye_tpu_torch import main as torch_main
from flye_tpu_torch.io.fasta import write_fasta
from flye_tpu_torch.ops import polish as TP
from flye_tpu_torch.parallel.runtime import ParallelContext, set_runtime
from flye_tpu_torch.utils import trace
from flye_tpu_torch.utils.simulate import random_genome, simulate_reads
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)


def _bubbles(seed, B=6, C=20, Cb=28, S=30, R=5):
    """Bubbles of C bases with 4 planted errors a candidate and R noisy
    branches of the true sequence."""
    rng = np.random.default_rng(seed)
    true = rng.integers(0, 4, (B, C)).astype(np.uint8)
    cand = np.zeros((B, Cb), np.uint8)
    cand[:, :C] = true
    for i in range(B):
        idx = rng.choice(C, 4, replace=False)
        cand[i, idx] = (cand[i, idx] + 1) % 4
    branches = np.zeros((B, R, S), np.uint8)
    branches[:, :, :C] = true[:, None, :]
    flip = rng.random((B, R, S)) < 0.03
    branches = np.where(flip, rng.integers(0, 4, (B, R, S)),
                        branches).astype(np.uint8)
    subs = np.log(np.full((5, 5), 0.05, np.float32))
    np.fill_diagonal(subs[:4, :4], np.log(0.8))
    return (cand, np.full(B, C, np.int32), branches,
            np.full((B, R), C, np.int32), np.ones((B, R), bool), subs)


def _climb_on(route, arrays, out_dir):
    """One `_Climb` run on the CPU on `route` inside a job; (outputs,
    the job's counters)."""
    cand, _, branches = arrays[:3]
    B, Cb = cand.shape
    shape = (B, Cb, *branches.shape)
    climb = TP._Climb(shape, torch.device("cpu"), route, 1, 64, True,
                      TP._CLIMB_STEPS)
    with trace.job(str(out_dir)):
        out = climb.run(arrays, 2 * Cb)
    return out, trace.job_record(str(out_dir))["counters"]


@pytest.mark.parametrize("seed", [1, 2])
def test_fused_route_counts_every_lane_step(seed, tmp_path):
    arrays = _bubbles(seed)
    fused, counts = _climb_on("polish_fused", arrays, tmp_path / "fused")
    plain, plain_counts = _climb_on("plain", arrays, tmp_path / "plain")
    assert counts["climb.lane_steps"] > 0
    assert counts["climb.fused_lane_steps"] == counts["climb.lane_steps"]
    assert plain_counts["climb.fused_lane_steps"] == 0
    assert plain_counts["climb.lane_steps"] == counts["climb.lane_steps"]
    for a, b in zip(fused, plain):
        assert a.tobytes() == b.tobytes()
    # the climb did edit: the planted errors are gone
    assert not np.array_equal(fused[0], arrays[0])


def test_polish_target_job_record(tmp_path):
    """A small standalone HiFi polish on the CPU: its record holds the
    polishing step, the reads and the climb's lane steps, and it writes
    polished_1.fasta."""
    genome = random_genome(20000, seed=11)
    rng = np.random.default_rng(12)
    keep = rng.random(len(genome)) >= 0.01      # a draft with deletions
    write_fasta([("draft", genome[keep])], str(tmp_path / "draft.fa"))
    reads = simulate_reads(genome, coverage=20, mean_length=8000,
                           error_rate=0.003, seed=13)
    write_fasta(reads, str(tmp_path / "reads.fa"))
    out = tmp_path / "out"
    rc = torch_main.main(["--polish-target", str(tmp_path / "draft.fa"),
                          "--pacbio-hifi", str(tmp_path / "reads.fa"),
                          "-o", str(out), "-i", "1", "--device", "cpu"])
    assert rc == 0
    rec = trace.job_record(str(out))
    assert any(n.startswith("polishing iteration") for n in rec["spans"])
    assert rec["counters"]["reads.count"] == len(reads)
    assert rec["counters"]["climb.lane_steps"] > 0
    polished = (out / "polished_1.fasta").read_text().split("\n", 1)[1]
    assert abs(len(polished.replace("\n", "")) - len(genome)) < 100
