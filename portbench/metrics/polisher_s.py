"""polisher_s: the sum of the "polishing iteration" steps per job (the
consensus and polishing stages, or the standalone polisher's
iterations), s, the mean over the traced window's jobs."""


def read(run):
    return run.step_mean(lambda name: name.startswith("polishing iteration"))
