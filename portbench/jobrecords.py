"""What the span and counter metrics read: the program's own record of
each of the traced window's jobs (`flye_tpu_torch.utils.trace`, found
by the job's output directory).  A program that keeps no such records
gives None, and so do the metrics that read them."""

import os


def records(run):
    """The window's job records, or None where a job has none."""
    try:
        from flye_tpu_torch.utils import trace
    except ImportError:
        return None
    recs = [trace.job_record(os.path.dirname(j["output"]))
            for j in run.jobs]
    return None if not recs or None in recs else recs


def span_mean(run, pred, key="total_s"):
    """The mean per job of `key` ("total_s" or "self_s") summed over
    the spans whose name meets pred, s."""
    recs = records(run)
    if recs is None:
        return None
    return sum(s[key] for r in recs for n, s in r["spans"].items()
               if pred(n)) / len(recs)


def counter_sum(run, name):
    """The counter summed over the window's jobs."""
    recs = records(run)
    if recs is None:
        return None
    return sum(r["counters"].get(name, 0) for r in recs)
