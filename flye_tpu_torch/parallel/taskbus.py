"""File-bus work queue for multi-process stage parallelism.

Port of `flye_tpu/parallel/taskbus.py`.  After contributing their ava
shard, worker processes stay alive as task servers for any stage the
coordinator fans out: read->draft mapping chunks and packed bubble
batches (`polishing/polisher.py`).  It is the per-host generalization of
the reference's process pool over bubbles (reference:
flye/polishing/bubbles.py:96-126 + the polisher's thread pool,
src/common/parallel.h:14-58), using the same inter-stage file-bus
discipline as the reference's stage dumps (reference:
src/repeat_graph/read_aligner.h:32-33) instead of lockstep collectives
— so the coordinator can submit work from arbitrary points of the
host-plane pipeline without every process having to reach a matching
barrier.  numpy and the filesystem only.

Protocol (single shared filesystem):
  tasks/<stage>.<id>.npz      submitted payload (atomic tmp+rename)
  claims/<stage>.<id>.<pid>   claim marker (atomic rename of the task
                              file — exactly one claimer wins)
  results/<stage>.<id>.npz    result payload
  DONE                        shutdown sentinel for workers

The coordinator participates in its own queues: `collect()` claims and
processes pending tasks (with its own handler — the card's kernels)
while waiting for worker results, so work-stealing balances the card
against slow CPU workers automatically.  If a worker dies mid-task,
`collect()` re-runs the orphaned payload itself after `reclaim_after`
seconds of no progress (claimed task files are kept until their result
appears).  Each bus counts the tasks it submitted, collected and ran
per stage (`stats`); `shutdown` and the end of `serve` log them.
"""

from __future__ import annotations

import collections
import glob
import json
import logging
import os
import socket
import threading
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np

logger = logging.getLogger("flye_tpu_torch")

Handler = Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]

_HEARTBEAT_S = 20.0  # claim-file touch period while a task runs

_bus: Optional["TaskBus"] = None


def get_bus() -> Optional["TaskBus"]:
    return _bus


def set_bus(bus: Optional["TaskBus"]) -> None:
    global _bus
    _bus = bus


class TaskBus:
    def __init__(self, root: str, process_index: int = 0):
        self.root = root
        self.pid = process_index
        self.handlers: Dict[str, Handler] = {}
        # tasks per stage this process submitted, collected and ran
        self.stats = {kind: collections.Counter()
                      for kind in ("submitted", "collected", "ran")}
        for d in ("tasks", "claims", "results"):
            os.makedirs(os.path.join(root, d), exist_ok=True)
        if process_index == 0:
            # coordinator-liveness record: same-host workers use it to
            # notice a SIGKILLed coordinator that never wrote DONE
            with open(os.path.join(root, "COORD"), "w") as f:
                json.dump({"pid": os.getpid(),
                           "host": socket.gethostname()}, f)

    def coordinator_dead(self) -> bool:
        """True when the coordinator process is provably gone (same
        host only; cross-host workers rely on the DONE sentinel)."""
        try:
            with open(os.path.join(self.root, "COORD")) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            return False
        if rec.get("host") != socket.gethostname():
            return False
        try:
            os.kill(int(rec["pid"]), 0)
            return False
        except ProcessLookupError:
            return True
        except OSError:
            return False

    # ---- shared helpers ----
    def _path(self, kind: str, stage: str, task_id) -> str:
        return os.path.join(self.root, kind, f"{stage}.{task_id}.npz")

    @staticmethod
    def _write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)  # atomic publish

    def register(self, stage: str, handler: Handler) -> None:
        self.handlers[stage] = handler

    # ---- coordinator side ----
    def submit(self, stage: str, task_id, arrays: Dict[str, np.ndarray]):
        self._write_npz(self._path("tasks", stage, task_id), arrays)
        self.stats["submitted"][stage] += 1

    def _try_claim(self, task_path: str) -> Optional[str]:
        """Atomically claim a task file; returns the claimed path."""
        base = os.path.basename(task_path)
        claimed = os.path.join(self.root, "claims", f"{base}.{self.pid}")
        try:
            os.rename(task_path, claimed)
            return claimed
        except OSError:
            return None  # somebody else won

    def _run_task(self, claimed_path: str) -> None:
        base = os.path.basename(claimed_path)
        stage, task_id = base.split(".")[0], base.split(".")[1]
        with np.load(claimed_path, allow_pickle=False) as z:
            payload = {k: z[k] for k in z.files}
        # heartbeat: touch the claim file while the handler runs so
        # collect() can tell a slow worker (fresh mtime) from a dead
        # one (stale mtime) and only re-runs truly orphaned claims
        stop = threading.Event()

        def _beat():
            while not stop.wait(_HEARTBEAT_S):
                try:
                    os.utime(claimed_path)
                except OSError:
                    return

        t = threading.Thread(target=_beat, daemon=True)
        t.start()
        try:
            out = self.handlers[stage](payload)
        finally:
            stop.set()
        self._write_npz(self._path("results", stage, task_id), out)
        self.stats["ran"][stage] += 1

    def _pending(self, stage: str):
        return sorted(glob.glob(
            os.path.join(self.root, "tasks", f"{stage}.*.npz")))

    def collect(self, stage: str, task_ids: Iterable,
                reclaim_after: float = 300.0) -> Dict[str, dict]:
        """Wait for all results, processing pending tasks meanwhile
        with this process's own handler (work stealing)."""
        want = {str(t) for t in task_ids}
        results: Dict[str, dict] = {}
        last_progress = time.monotonic()
        while want:
            got = False
            for tid in sorted(want):
                rp = self._path("results", stage, tid)
                if os.path.exists(rp):
                    with np.load(rp, allow_pickle=False) as z:
                        results[tid] = {k: z[k] for k in z.files}
                    want.discard(tid)
                    self.stats["collected"][stage] += 1
                    got = True
                    break
            if got:
                last_progress = time.monotonic()
                continue
            # steal a pending task for ourselves
            stolen = False
            for tp in self._pending(stage):
                claimed = self._try_claim(tp)
                if claimed:
                    self._run_task(claimed)
                    os.unlink(claimed)
                    stolen = True
                    break
            if stolen:
                last_progress = time.monotonic()
                continue
            if time.monotonic() - last_progress > reclaim_after:
                # a worker died mid-task: re-run orphaned claims here.
                # Live workers heartbeat their claim file (_run_task),
                # so only claims with a STALE mtime re-run — a slow but
                # alive worker is left alone.  (Result files publish
                # atomically; if the worker finishes anyway, first
                # publish wins and both are valid outputs of the same
                # payload.)
                now = time.time()
                for tid in sorted(want):
                    orphans = glob.glob(os.path.join(
                        self.root, "claims", f"{stage}.{tid}.npz.*"))
                    stale = [p for p in orphans
                             if now - os.path.getmtime(p) >
                             3 * _HEARTBEAT_S]
                    if stale:
                        logger.warning("taskbus: re-running orphaned "
                                       "task %s.%s", stage, tid)
                        self._run_task(stale[0])
                last_progress = time.monotonic()
                continue
            time.sleep(0.05)
        return results

    def stats_text(self) -> str:
        return ", ".join(f"{kind} {dict(sorted(c.items()))}"
                         for kind, c in self.stats.items())

    def shutdown(self) -> None:
        with open(os.path.join(self.root, "DONE"), "w") as f:
            f.write("done\n")
        logger.info("taskbus process %d: %s", self.pid, self.stats_text())

    # ---- worker side ----
    def serve(self, poll_s: float = 0.1) -> None:
        """Worker loop: claim and run tasks until the DONE sentinel."""
        done = os.path.join(self.root, "DONE")
        logger.info("taskbus worker %d serving %s", self.pid, self.root)
        n_done = 0
        while True:
            ran = False
            for stage in self.handlers:
                for tp in self._pending(stage):
                    claimed = self._try_claim(tp)
                    if claimed:
                        self._run_task(claimed)
                        os.unlink(claimed)
                        n_done += 1
                        ran = True
                        break
                if ran:
                    break
            if ran:
                continue
            if os.path.exists(done):
                logger.info("taskbus worker %d: done (%d tasks)",
                            self.pid, n_done)
                logger.info("taskbus process %d: %s", self.pid,
                            self.stats_text())
                return
            if self.coordinator_dead():
                logger.warning("taskbus worker %d: coordinator gone "
                               "without DONE; exiting (%d tasks)",
                               self.pid, n_done)
                return
            time.sleep(poll_s)
