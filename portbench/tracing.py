"""The traced run's reduction: from torch.profiler's events over the
window's jobs to the device's busy time, kernel time by name, and the
idle gaps labelled by what the host was doing (the `_union_ms` and
`trace_report` arithmetic of `chip_smoke.py`, on the profiler's own
event list instead of its exported file).

Each job runs inside a range JOB_RANGE + its number; the device is busy
where some kernel runs (the union of the kernel intervals), clipped to
the jobs.  A gap is labelled with the innermost program range open on
the host when it starts: the stage ("stage <job>") or step (the
program's `stage_timer` names, its "climb ..." ranges) that held the
card idle.
"""

from __future__ import annotations

import bisect
import collections

JOB_RANGE = "portbench job "


def kernel_name(name: str) -> str:
    """A kernel's name without its return type and its argument list
    (the last parenthesised group; a namespace such as "(anonymous
    namespace)::" stays)."""
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:120]


def events_of(prof):
    """(kernels, ranges): kernels as (start ns, end ns, name) of every
    device kernel, ranges as (start ns, end ns, name) of every host
    range of record_function.  A device event is a kernel unless it is
    a copy, a fill or the device's mirror of a host range."""
    kernels, ranges = [], []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.activity_type()) if hasattr(e, "activity_type") \
            else ""
        on_device = str(e.device_type()).endswith("CUDA")
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        name = e.name()
        if on_device:
            if kind == "kernel" or not (
                    e.is_user_annotation() or "user_annotation" in kind
                    or name.startswith(("Memcpy", "Memset"))
                    or "memcpy" in kind or "memset" in kind):
                kernels.append((t0, t1, name))
        elif e.is_user_annotation():
            ranges.append((t0, t1, name))
    return kernels, ranges


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def clip_union(merged, lo, hi):
    """Length of the merged intervals inside [lo, hi]."""
    total = 0
    for a, b in merged:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            total += b - a
    return total


def reduce(kernels, ranges, top=10):
    """The window's device numbers: {"jobs": [(start, end)], "window_s",
    "busy_s", "idle_share", "kernel_s": {name: s}, "device_ops",
    "idle_gaps"}; times in seconds, from ns events."""
    jobs = sorted((a, b) for a, b, n in ranges if n.startswith(JOB_RANGE))
    inner = sorted((a, b, n) for a, b, n in ranges
                   if not n.startswith(JOB_RANGE))
    in_jobs = [(a, b, n) for a, b, n in kernels
               if any(a < hi and b > lo for lo, hi in jobs)]
    merged = merge([(a, b) for a, b, _ in in_jobs])
    window = sum(hi - lo for lo, hi in jobs)
    busy = sum(clip_union(merged, lo, hi) for lo, hi in jobs)
    by_name = collections.Counter()
    for a, b, n in in_jobs:
        by_name[kernel_name(n)] += (b - a) / 1e9
    gaps = []
    for lo, hi in jobs:
        t = lo
        for a, b in merged:
            if b <= lo or a >= hi:
                continue
            if a > t:
                gaps.append((a - t, t))
            t = max(t, b)
        if hi > t:
            gaps.append((hi - t, t))
    gaps.sort(reverse=True)
    starts = [a for a, _, _ in inner]

    def label(t):
        """The innermost range open at t: the latest start before t
        whose range still holds t."""
        i = bisect.bisect_right(starts, t)
        for a, b, n in reversed(inner[:i]):
            if b > t:
                return n
        return "between the program's ranges"
    return {
        "jobs": [((a, b)) for a, b in jobs],
        "window_s": window / 1e9,
        "busy_s": busy / 1e9,
        "idle_share": 1.0 - busy / window if window else None,
        "kernel_s": dict(by_name),
        "device_ops": [[n, s] for n, s in by_name.most_common(top)],
        "idle_gaps": [[label(t), d / 1e9] for d, t in gaps[:top]],
    }
