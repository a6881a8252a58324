"""device_idle_share: the share of the traced jobs' time in which no
kernel runs on the card, %: one less the union of the profiler's kernel
intervals, clipped to the jobs, over the jobs' time."""


def read(run):
    share = run.trace.get("idle_share") if run.trace else None
    return None if share is None else 100.0 * share
