"""flye_tpu_torch's span and counter recorder (`utils/trace.py`): spans
nest, across worker threads too, and a span's self time is its
duration less the union of its children's intervals; jobs are kept by
output directory, the last 16; counters are exact from many threads;
a job keeps its kernel-launch deltas; a span starts on the profiler's
clock; `stage_timer` writes its two log lines as before, which the
benchmark's log reader parses; no range opens without a profiler."""

import importlib.util
import logging
import os
import re
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from flye_tpu_torch.ops import _cuda
from flye_tpu_torch.parallel.runtime import ParallelContext, set_runtime
from flye_tpu_torch.utils import trace
from flye_tpu_torch.utils.logs import stage_timer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)


def _raw(job, name):
    return [s for s in job.spans if s[0] == name]


def test_self_time_subtracts_the_union_of_the_childrens_intervals():
    # (name, id, parent, thread, start ns, end ns): two children of one
    # parent overlap by 20 ns, a grandchild lies inside the first
    spans = [("child", 2, 1, 11, 10, 50), ("child", 3, 1, 12, 30, 70),
             ("leaf", 4, 2, 11, 20, 40), ("parent", 1, 0, 10, 0, 100)]
    rec = trace._by_name(spans)
    assert rec["parent"] == {"calls": 1, "total_s": 100e-9,
                             "self_s": pytest.approx(40e-9)}
    assert rec["child"]["calls"] == 2
    assert rec["child"]["total_s"] == pytest.approx(80e-9)
    assert rec["child"]["self_s"] == pytest.approx(60e-9)
    assert rec["leaf"]["self_s"] == pytest.approx(20e-9)
    # a child reaching past its parent counts only inside it
    assert trace._covered([(-5, 5), (90, 120)], 0, 100) == 15


def test_worker_threads_spans_nest_under_the_span_that_submitted_them(
        tmp_path):
    both = threading.Barrier(2, timeout=10)

    def work():
        with trace.span("child"):
            both.wait()          # the two children overlap
            time.sleep(0.05)
        return threading.get_ident()

    with trace.job(str(tmp_path)) as job:
        with trace.span("parent"):
            with ThreadPoolExecutor(max_workers=2) as ex:
                futs = [ex.submit(trace.carry(work)) for _ in range(2)]
                threads = {f.result(timeout=30) for f in futs}
            time.sleep(0.02)
    assert len(threads) == 2
    (parent,) = _raw(job, "parent")
    children = _raw(job, "child")
    assert len(children) == 2
    assert all(c[2] == parent[1] for c in children)
    assert {c[3] for c in children} == threads
    (root,) = _raw(job, "job")
    assert parent[2] == root[1]
    dur = parent[5] - parent[4]
    union = trace._covered([(c[4], c[5]) for c in children],
                           parent[4], parent[5])
    summed = sum(c[5] - c[4] for c in children)
    assert union < summed        # they overlapped
    rec = trace.job_record(str(tmp_path))
    assert rec["spans"]["parent"]["self_s"] == pytest.approx(
        (dur - union) / 1e9)
    assert rec["spans"]["parent"]["self_s"] >= 0.015
    assert rec["spans"]["child"]["calls"] == 2


def test_jobs_are_kept_by_out_dir_the_last_16(tmp_path):
    dirs = [str(tmp_path / f"d{i}") for i in range(17)]
    with trace.span("outside any job"):
        pass
    for d in dirs:
        with trace.job(d):
            trace.count("n", len(d))
    assert trace.job_record(dirs[0]) is None       # the 17th pushed it out
    recs = [trace.job_record(d) for d in dirs[1:]]
    assert [r["out_dir"] for r in recs] == [os.path.abspath(d)
                                           for d in dirs[1:]]
    seqs = [r["seq"] for r in recs]
    assert seqs == sorted(set(seqs))
    assert all(r["id"] == f"{r['seq']}:{r['out_dir']}" for r in recs)
    assert all(r["counters"] == {"n": len(d)}
               for r, d in zip(recs, dirs[1:]))
    assert all("outside any job" not in r["spans"] for r in recs)
    assert all(r["raw"] is None for r in recs)   # no profiler ran
    # the same directory again: the latest job's record
    with trace.job(dirs[5]):
        trace.count("again")
    assert trace.job_record(dirs[5] + "/")["counters"] == {"again": 1}


def test_counters_are_exact_from_many_threads(tmp_path):
    n_threads, n = 8, 5000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.job(str(tmp_path)):
            start = threading.Barrier(n_threads, timeout=10)

            def work():
                start.wait()
                for _ in range(n):
                    trace.count("hits")
                    trace.count("pairs", 2)
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    counters = trace.job_record(str(tmp_path))["counters"]
    assert counters == {"hits": n_threads * n, "pairs": 2 * n_threads * n}


def test_a_job_keeps_its_kernel_launch_deltas(tmp_path):
    _cuda.LAUNCHES["levenshtein"] += 5          # before the job: not its
    with trace.job(str(tmp_path / "a")):
        _cuda.LAUNCHES["chain_dp"] += 3
        _cuda.LAUNCHES["polish_backward"] += 1
    with trace.job(str(tmp_path / "b")):
        pass
    assert trace.job_record(str(tmp_path / "a"))["launches"] == {
        "chain_dp": 3, "polish_backward": 1}
    assert trace.job_record(str(tmp_path / "b"))["launches"] == {}


def test_readbacks_count_device_reads_only(tmp_path):
    cpu = torch.zeros(3)
    with trace.job(str(tmp_path)):
        assert trace.readback(cpu) is cpu
        trace.readback(torch.device("cpu"))
        dev = torch.device("cuda")
        assert trace.readback(dev) is dev
    assert trace.job_record(str(tmp_path))["counters"] == {
        "device.readbacks": 1}


def test_a_span_starts_on_the_profilers_clock(tmp_path):
    import torch.profiler as tp
    with tp.profile(activities=[tp.ProfilerActivity.CPU]) as prof:
        with trace.job(str(tmp_path)) as job:
            for _ in range(3):
                with trace.span("clock probe"):
                    torch.ones(8).sum()
    ranges = sorted(e.start_ns() for e in
                    prof.profiler.kineto_results.events()
                    if e.is_user_annotation() and e.name() == "clock probe")
    starts = sorted(s[4] for s in _raw(job, "clock probe"))
    assert len(ranges) == len(starts) == 3
    for r, s in zip(ranges, starts):
        assert abs(r - s) < 2_000_000, (r, s)
    # under a profiler the record keeps the raw spans
    assert len(trace.job_record(str(tmp_path))["raw"]) == 4


def test_no_range_opens_without_a_profiler(monkeypatch, tmp_path):
    opened = []
    real = torch.profiler.record_function

    def spy(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with trace.job(str(tmp_path)):
        with trace.span("quiet"):
            pass
        with stage_timer("quiet step"):
            pass
    assert opened == []
    import torch.profiler as tp
    with tp.profile(activities=[tp.ProfilerActivity.CPU]):
        with trace.span("loud"):
            pass
    assert opened == ["loud"]


def _stage_log():
    """portbench/run.py's StageLog, the benchmark's reader of the step
    lines."""
    path = os.path.join(ROOT, "portbench", "run.py")
    spec = importlib.util.spec_from_file_location("portbench_run", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.StageLog()


def test_stage_timer_lines_are_unchanged_and_parsed(tmp_path):
    msgs = []

    class Keep(logging.Handler):
        def emit(self, record):
            msgs.append(record.getMessage())
    log = logging.getLogger("flye_tpu_torch")
    keep, stages = Keep(logging.DEBUG), _stage_log()
    root = logging.getLogger()
    old_level = log.level
    log.setLevel(logging.DEBUG)
    log.addHandler(keep)
    root.addHandler(stages)
    try:
        with trace.job(str(tmp_path)):
            with stage_timer("index build"):
                time.sleep(0.01)
            with stage_timer("polish: bubble kernels"):
                pass
    finally:
        log.removeHandler(keep)
        root.removeHandler(stages)
        log.setLevel(old_level)
    assert msgs[0] == "index build: started"
    assert re.fullmatch(r"index build: done in \d+\.\d s \[RSS \d+\.\d "
                        r"[KMG]?b \(peak \d+\.\d [KMG]?b\)\]", msgs[1])
    assert msgs[2] == "polish: bubble kernels: started"
    assert msgs[3].startswith("polish: bubble kernels: done in ")
    # the job's summary line is neither a step's start nor its end
    summary = msgs[4]
    assert summary.startswith("job ") and "index build" in summary
    assert not summary.endswith(": started") and ": done in " not in summary
    assert [n for n, _ in stages.steps] == ["index build",
                                            "polish: bubble kernels"]
    assert stages.steps[0][1] >= 0.009
    assert stages.open == {"index build": [], "polish: bubble kernels": []}
    rec = trace.job_record(str(tmp_path))
    assert rec["spans"]["index build"]["total_s"] >= 0.009
