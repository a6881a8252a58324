"""climb_capture_s: the "climb: capture" spans per job (a climb's
CUDA-graph capture with its eager warm-up step), s, the mean over the
traced window's jobs; 0 where no graph is captured."""

import jobrecords


def read(run):
    return jobrecords.span_mean(run, lambda n: n == "climb: capture")
