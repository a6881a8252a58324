"""assembly_s: the assembly stage's wall per job (its ">>> STAGE"
line to the next), s, the mean over the traced window's jobs."""


def read(run):
    return run.stage_mean("assembly")
