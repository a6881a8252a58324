"""overlap_s: the "overlap prefetch" step's wall per job (the
all-vs-all overlap of the assembly stage), s, the mean over the traced
window's jobs."""


def read(run):
    return run.step_mean(lambda name: name == "overlap prefetch")
