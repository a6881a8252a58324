"""unstepped_s: the job's time that no step covers, s, the mean over
the traced window's jobs: the self time of the "job" span, of
"pipeline: setup" and of the "stage <job>" spans (each span's time
less the union of its children's)."""

import jobrecords


def read(run):
    return jobrecords.span_mean(
        run, lambda n: n in ("job", "pipeline: setup")
        or n.startswith("stage "), key="self_s")
