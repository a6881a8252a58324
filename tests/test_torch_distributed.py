"""flye_tpu_torch's multi-process topology (`parallel/distributed.py`)
against the JAX package's: single-process degradation, the read
partition and the file barrier.  The counterpart of
tests/test_distributed.py."""

import threading

import numpy as np
import pytest

from flye_tpu.parallel.distributed import host_partition as jax_partition
from flye_tpu_torch.parallel import (ParallelContext, host_partition,
                                     init_distributed, is_coordinator,
                                     set_runtime)
from flye_tpu_torch.parallel import distributed as D


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)
    D.set_barrier_abort_file(None)


def test_init_single_process_noop(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_distributed() == (0, 1)
    assert is_coordinator()
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "3")
    assert init_distributed() == (1, 3)


@pytest.mark.parametrize("p,count", [(0, 1), (0, 4), (1, 4), (2, 4),
                                     (3, 4), (1, 3)])
def test_host_partition_matches_jax(p, count):
    rng = np.random.default_rng(3)
    fwd = rng.choice(1000, 200, replace=False) * 2
    # both strands of most reads, one strand of some, in shuffled order
    ids = [int(i) for f in fwd for i in (f, f + 1)][:-7]
    ids = [ids[j] for j in rng.permutation(len(ids))]
    out = host_partition(ids, p, count)
    assert out == jax_partition(ids, p, count)
    parts = [host_partition(ids, q, count) for q in range(count)]
    assert sorted(x for part in parts for x in part) == sorted(ids)
    fwd_sizes = [len({i & ~1 for i in part}) for part in parts]
    assert max(fwd_sizes) - min(fwd_sizes) <= 1
    for part in parts:
        s = set(part)
        for i in part:
            assert (i ^ 1) in s or (i ^ 1) not in ids


def test_file_barrier_across_processes(tmp_path):
    """Process 0 (a thread here) waits in the barrier until process 1's
    sentinel appears, then passes."""
    passed = []

    def arrive(pid):
        D.file_barrier(str(tmp_path), "b", timeout_s=30, poll_s=0.01)
        passed.append(pid)

    set_runtime(ParallelContext("cpu", 0, 2))
    t = threading.Thread(target=arrive, args=(0,))
    t.start()
    t.join(0.3)
    assert t.is_alive() and not passed    # waits for process 1
    # process 1's sentinel, as its own file_barrier writes it
    (tmp_path / ".barriers" / "b.1").write_text("x")
    t.join(10)
    assert passed == [0]


def test_file_barrier_aborts_on_done(tmp_path):
    set_runtime(ParallelContext("cpu", 1, 2))
    done = tmp_path / "DONE"
    D.set_barrier_abort_file(str(done))
    done.write_text("done\n")
    with pytest.raises(D.BarrierAborted):
        D.file_barrier(str(tmp_path), "ava_shards", timeout_s=30,
                       poll_s=0.01)
