"""The program's spans and counters, kept per job.

A job is one call of `main.main()`: `job(out_dir)` opens it, with the
root span "job", and leaves a record that `job_record(out_dir)` finds
(the last 16 jobs of the process): per span name, the calls, the total
seconds and the self seconds (a span's duration less the union of its
children's intervals, so that two worker threads under one parent are
not counted twice), the job's counters, and its kernel launches (its
deltas of `ops._cuda.LAUNCHES`).  At its end the job logs one summary
line: the ten spans with the most self time, and the counters.

`span(name)` times a piece of work on `time.time_ns()`, the clock of
torch.profiler's events, and records it with its thread and its parent:
the innermost span open in this thread, or, in a worker thread that
runs a callable wrapped by `carry()`, the span open where the work was
submitted.  While a profiler is enabled on the thread, a span is also a
`record_function` range of the same name, and the job keeps its raw
spans; otherwise a span costs two clock reads, a context variable's set
and reset, and an append.

`count(name, n)` adds to a counter of the job; it is safe from any
thread.  `readback(x)` counts one blocking device-to-host read that its
caller is about to make of x.  Nothing here synchronises the device or
reads a device value.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import itertools
import logging
import os
import threading
import time
from typing import Deque, Dict, List, Optional

import torch

logger = logging.getLogger("flye_tpu_torch")

_parent = contextvars.ContextVar("flye_tpu_torch_span", default=0)
_ids = itertools.count(1)
_seq = itertools.count(1)
_lock = threading.Lock()
_open: List["_Job"] = []          # jobs open in this process, innermost last
_records: Deque[dict] = collections.deque(maxlen=16)
_profiling = torch._C._autograd._profiler_enabled


class _Job:
    def __init__(self, out_dir: str, launches: Dict[str, int]):
        self.seq = next(_seq)
        self.out_dir = os.path.abspath(out_dir)
        self.launches = dict(launches)
        # (name, id, parent id, thread, start ns, end ns), as spans close
        self.spans: list = []
        self.counters: collections.Counter = collections.Counter()
        self.profiled = False


def _current() -> Optional[_Job]:
    return _open[-1] if _open else None


class span:
    """`with span(name):` times the block as a span of the open job (no
    record outside a job).  `seconds` holds its duration once closed."""

    __slots__ = ("name", "sid", "parent", "token", "t0", "t1", "rng")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.sid = next(_ids)
        self.parent = _parent.get()
        self.token = _parent.set(self.sid)
        self.rng = None
        if _profiling():
            self.rng = torch.profiler.record_function(self.name)
            self.rng.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        if self.rng is not None:
            self.rng.__exit__(*exc)
        _parent.reset(self.token)
        job = _current()
        if job is not None:
            if self.rng is not None:
                job.profiled = True
            job.spans.append((self.name, self.sid, self.parent,
                              threading.get_ident(), self.t0, self.t1))
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


def count(name: str, n: int = 1) -> None:
    """Add n to the open job's counter `name`."""
    job = _current()
    if job is not None:
        with _lock:
            job.counters[name] += n


def readback(x):
    """Count one blocking device-to-host read of x (a tensor, or a
    device that is synchronised) if x is on a CUDA device; returns x."""
    dev = x if isinstance(x, torch.device) else x.device
    if dev.type == "cuda":
        count("device.readbacks")
    return x


def carry(fn):
    """fn, to run in a worker thread under the spans open here: its
    spans get the caller's innermost open span as their parent."""
    return functools.partial(contextvars.copy_context().run, fn)


def _covered(intervals, lo: int, hi: int) -> int:
    """Length of the union of the intervals clipped to [lo, hi]."""
    total, end = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def _by_name(spans) -> Dict[str, dict]:
    kids = collections.defaultdict(list)
    for _, _, parent, _, t0, t1 in spans:
        kids[parent].append((t0, t1))
    acc: Dict[str, list] = {}
    for name, sid, _, _, t0, t1 in spans:
        a = acc.setdefault(name, [0, 0, 0])
        a[0] += 1
        a[1] += t1 - t0
        a[2] += t1 - t0 - _covered(kids.get(sid, ()), t0, t1)
    return {n: {"calls": c, "total_s": tot / 1e9, "self_s": own / 1e9}
            for n, (c, tot, own) in acc.items()}


def summary(rec: dict) -> str:
    """The record's operator line: the ten spans with the most self
    time, then the counters."""
    spans = sorted(rec["spans"].items(), key=lambda kv: -kv[1]["self_s"])
    parts = [f"{n} {s['self_s']:.2f}" for n, s in spans[:10]]
    counts = [f"{n} {v}" for n, v in sorted(rec["counters"].items())]
    return (f"job {rec['seq']} time by span (self s): " + ", ".join(parts)
            + "; counters: " + (", ".join(counts) or "none"))


@contextlib.contextmanager
def job(out_dir: str):
    """One job of the program under the root span "job", writing to
    out_dir; its record is kept once it ends."""
    from flye_tpu_torch.ops import _cuda
    j = _Job(out_dir, _cuda.LAUNCHES)
    with _lock:
        _open.append(j)
    root = span("job")
    try:
        with root:
            yield j
    finally:
        with _lock:
            _open.remove(j)
            counters = dict(j.counters)
        rec = {"id": f"{j.seq}:{j.out_dir}", "seq": j.seq,
               "out_dir": j.out_dir, "wall_s": root.seconds,
               "spans": _by_name(j.spans), "counters": counters,
               "launches": {k: v - j.launches.get(k, 0)
                            for k, v in _cuda.LAUNCHES.items()
                            if v != j.launches.get(k, 0)},
               "raw": j.spans if j.profiled else None}
        _records.append(rec)
        logger.info("%s", summary(rec))


def job_record(out_dir: str) -> Optional[dict]:
    """The record of the latest ended job that wrote to out_dir, or
    None."""
    key = os.path.abspath(out_dir)
    for rec in reversed(_records):
        if rec["out_dir"] == key:
            return rec
    return None
