"""The port on two OS processes of one host, on the CPU: the round-robin
read partition splits the all-vs-all overlaps, the worker's shard
merges through the shared output directory, and the coordinator fans
read mapping and bubble polishing out over the file task bus while the
worker serves it.  Every process runs the native CPU climber, so the
files must be byte-identical to `flye_tpu`'s single-process run.  The
counterpart of tests/test_multihost.py, at its input."""

import ast
import filecmp
import os
import re
import subprocess
import sys

import pytest

import flye_tpu.main as jax_main
from flye_tpu_torch.io.fasta import write_fasta
from flye_tpu_torch.utils.simulate import random_genome, simulate_reads
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = ("assembly.fasta", "assembly_graph.gfa", "assembly_info.txt",
           "00-assembly/draft_assembly.fasta")
# one process of the port's CLI: the port only (no JAX), one torch thread
_STUB = ("import sys, torch; torch.set_num_threads(1); "
         "from flye_tpu_torch.main import main; sys.exit(main(sys.argv[1:]))")
_STATS = re.compile(r"taskbus process (\d+): submitted (\{.*?\}), "
                    r"collected (\{.*?\}), ran (\{.*?\})")


def _run_two(reads_path, out, *extra, timeout=300):
    """Both processes of a 2-process run; returns their logs (stderr)."""
    env = dict(os.environ, WORLD_SIZE="2")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    argv = ["--pacbio-raw", str(reads_path), "-o", str(out), "-g", "20k",
            "-m", "1500", "--device", "cpu", *extra]
    procs = [subprocess.Popen([sys.executable, "-c", _STUB, *argv],
                              env=dict(env, RANK=str(rank)),
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for rank in (0, 1)]
    try:
        logs = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {rank}:\n{log[-3000:]}"
    return logs


def _bus_stats(log):
    found = _STATS.findall(log)
    assert len(found) == 1, found
    # submitted, collected, ran
    return [ast.literal_eval(d) for d in found[0][1:]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("multiproc")
    genome = random_genome(20000, seed=3)
    reads = simulate_reads(genome, coverage=12, mean_length=4000,
                           error_rate=0.05, seed=5, circular=False)
    path = d / "reads.fasta"
    write_fasta(reads, str(path))
    assert jax_main.main(["--pacbio-raw", str(path), "-o", str(d / "jax"),
                          "-g", "20k", "-m", "1500", "--shards", "1"]) == 0
    logs = _run_two(path, d / "two")
    return d, path, logs


def test_two_processes_share_the_work(runs):
    d, _, logs = runs
    # the worker's shard: the ava partition really ran on two processes
    assert (d / "two" / "00-assembly" / "ava_shard_1.npz").exists()
    for rank, log in enumerate(logs):
        mine, total = map(int, re.search(
            rf"host {rank}/2: computing overlaps for (\d+) of (\d+) reads",
            log).groups())
        assert 0 < mine < total
    assert "ava shard merge: done" in logs[0]
    submitted, collected, ran = _bus_stats(logs[0])
    for stage in ("map", "polish"):
        assert submitted.get(stage, 0) >= 1, submitted
        assert collected.get(stage, 0) == submitted[stage], collected
    _, _, worker_ran = _bus_stats(logs[1])
    # work stealing decides who ran what; every task ran once
    for stage in ("map", "polish"):
        assert ran.get(stage, 0) + worker_ran.get(stage, 0) == \
            submitted[stage]
    print(f"tasks run: coordinator {ran}, worker {worker_ran}")


@pytest.mark.parametrize("rel", OUTPUTS)
def test_two_processes_match_flye_tpu(runs, rel):
    d = runs[0]
    assert filecmp.cmp(d / "jax" / rel, d / "two" / rel, shallow=False)


def test_stop_after_assembly_ends_both(runs):
    d, path, _ = runs
    logs = _run_two(path, d / "stop", "--stop-after", "assembly")
    assert "Stopped after stage 'assembly'" in logs[0]
    assert "worker process 1 finished" in logs[1]
    rel = "00-assembly/draft_assembly.fasta"
    assert filecmp.cmp(d / "two" / rel, d / "stop" / rel, shallow=False)
    assert not (d / "stop" / "10-consensus" / "consensus.fasta").exists()
