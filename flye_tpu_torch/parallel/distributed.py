"""Multi-process topology on one host: per-process read partition and
file barriers.

Port of `flye_tpu/parallel/distributed.py`.  N processes of the same
CLI share one output directory; process 0 is the coordinator.  Each
computes the all-vs-all overlaps of its round-robin read partition
(`host_partition`), the workers dump their shards, all meet at a file
barrier (`file_barrier`), and the coordinator merges the shards and
carries the host-plane stages alone while the workers serve the file
task bus (`parallel/taskbus.py`).  This plane needs only (index, count)
and a shared filesystem: nothing in it runs a collective, so no
`torch.distributed` process group is opened.  The hash-partitioned mode
(`partitioned.py`) exchanges its counts, postings and match streams
over the same files; the mesh collectives (`mesh.py`) run between the
devices of one process.

The topology comes from PyTorch's launcher convention, `RANK` and
`WORLD_SIZE` (set by `torchrun --standalone --nproc-per-node N`, or by
hand).  Single-process runs get (0, 1) and every helper degrades to
the identity.
"""

from __future__ import annotations

import os
import shutil
import time
import uuid
from typing import List, Optional, Sequence, Tuple


def init_distributed() -> Tuple[int, int]:
    """(process_index, process_count) of this run, from `RANK` and
    `WORLD_SIZE`; (0, 1) when `WORLD_SIZE` is not set."""
    count = int(os.environ.get("WORLD_SIZE") or 1)
    rank = int(os.environ.get("RANK") or 0)
    if not 0 <= rank < count:
        raise ValueError(f"RANK {rank} outside WORLD_SIZE {count}")
    return rank, count


def host_partition(ids: Sequence[int], process_index: Optional[int] = None,
                   process_count: Optional[int] = None) -> List[int]:
    """Deterministic per-process slice of a read-id list.

    Round-robin by sorted position so every process holds an
    interleaved, length-balanced subset regardless of id density.  With
    one process this is the identity.  Forward/reverse strand pairs
    (id, id^1) stay on the same process (partition on the forward id).
    """
    if process_index is None or process_count is None:
        from flye_tpu_torch.parallel.runtime import get_runtime
        rt = get_runtime()
        process_index = rt.process_index
        process_count = rt.process_count
    if process_count <= 1:
        return list(ids)
    fwd = sorted({i & ~1 for i in ids})
    mine = {f for n, f in enumerate(fwd) if n % process_count ==
            process_index}
    return [i for i in ids if (i & ~1) in mine]


def is_coordinator() -> bool:
    """True on the process that runs the host-plane stages (repeat
    graph, contigger, ...); the others serve the task bus meanwhile."""
    from flye_tpu_torch.parallel.runtime import get_runtime
    return get_runtime().process_index == 0


class BarrierAborted(RuntimeError):
    """The run's coordinator signalled completion/shutdown (DONE) while
    this process was waiting in a barrier — e.g. a `--stop-after` stage
    the coordinator never enters.  Callers on worker processes catch
    this and fall back to serving the task bus / exiting cleanly."""


_abort_file: Optional[str] = None


def set_barrier_abort_file(path: Optional[str]) -> None:
    """Register a sentinel (the task bus's DONE file) that aborts any
    in-progress file_barrier wait — so workers never sit out a full
    barrier timeout after the coordinator has already shut down."""
    global _abort_file
    _abort_file = path


def file_barrier(work_dir: str, name: str, timeout_s: float = 3600.0,
                 poll_s: float = 0.05) -> None:
    """Filesystem barrier across the run's processes: each process
    drops `<work_dir>/.barriers/<name>.<pid>` and waits for all
    `process_count` sentinels.  The processes already share the
    filesystem for the shard files, so the barrier needs no collective
    transport (the coordinator on the card and CPU workers need not
    share one)."""
    from flye_tpu_torch.parallel.runtime import get_runtime
    rt = get_runtime()
    pid, count = rt.process_index, rt.process_count
    if count <= 1:
        return
    bdir = os.path.join(work_dir, ".barriers")
    os.makedirs(bdir, exist_ok=True)
    mine = os.path.join(bdir, f"{name}.{pid}")
    with open(mine, "w") as f:
        f.write("x")
    deadline = time.monotonic() + timeout_s
    while True:
        n = sum(os.path.exists(os.path.join(bdir, f"{name}.{p}"))
                for p in range(count))
        if n >= count:
            return
        if _abort_file is not None and os.path.exists(_abort_file):
            raise BarrierAborted(
                f"file_barrier {name}: coordinator DONE at {n}/{count}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"file_barrier {name}: {n}/{count}")
        time.sleep(poll_s)


def _publish(path: str, text: str) -> None:
    """Write `text` to `path` atomically (write, then rename)."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def start_rendezvous(run_dir: str, timeout_s: float = 3600.0,
                     poll_s: float = 0.05) -> None:
    """The start of a multi-process run: no worker goes on before the
    coordinator, which calls this once it has removed what a prior
    attempt left in `run_dir` (barrier sentinels, exchange files), has
    seen it.  The JAX package's processes get this hold from
    `jax.distributed.initialize`; without it a worker that starts
    first could publish a barrier sentinel or an exchange file that
    the coordinator's cleanup then deletes, and the run would wait
    forever.

    Each worker publishes a fresh nonce in `run_dir/.hello/<p>` and
    waits for the coordinator to echo it in `<p>.ack`; it publishes the
    nonce again whenever the file is gone (the coordinator clears
    `.hello` first, which drops a prior attempt's nonces and echoes).
    """
    from flye_tpu_torch.parallel.runtime import get_runtime
    rt = get_runtime()
    pid, count = rt.process_index, rt.process_count
    if count <= 1:
        return
    hdir = os.path.join(run_dir, ".hello")
    deadline = time.monotonic() + timeout_s

    def wait(what):
        if time.monotonic() > deadline:
            raise TimeoutError(f"start_rendezvous: {what}")
        time.sleep(poll_s)

    if pid == 0:
        shutil.rmtree(hdir, ignore_errors=True)
        os.makedirs(hdir, exist_ok=True)
        pending = set(range(1, count))
        while pending:
            for w in sorted(pending):
                try:
                    with open(os.path.join(hdir, str(w))) as f:
                        nonce = f.read()
                except FileNotFoundError:
                    continue
                _publish(os.path.join(hdir, f"{w}.ack"), nonce)
                pending.discard(w)
            if pending:
                wait(f"no word from processes {sorted(pending)}")
        return
    nonce = uuid.uuid4().hex
    mine = os.path.join(hdir, str(pid))
    while True:
        try:
            with open(mine + ".ack") as f:
                if f.read() == nonce:
                    return
        except FileNotFoundError:
            pass
        if not os.path.exists(mine):
            try:
                os.makedirs(hdir, exist_ok=True)
                _publish(mine, nonce)
            except FileNotFoundError:   # the coordinator's cleanup
                continue
        wait("no word from the coordinator")
