"""bubble_pack_s: the "bubbles: pack" spans per job (bucketing the
bubbles, merging small buckets and packing each batch's arrays on the
host), s, the mean over the traced window's jobs."""

import jobrecords


def read(run):
    return jobrecords.span_mean(run, lambda n: n == "bubbles: pack")
