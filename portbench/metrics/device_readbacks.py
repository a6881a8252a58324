"""device_readbacks: the program's blocking device-to-host reads per
job (its `device.readbacks` counter), the mean over the traced window's
jobs."""

import jobrecords


def read(run):
    n = jobrecords.counter_sum(run, "device.readbacks")
    return None if n is None else n / len(run.jobs)
