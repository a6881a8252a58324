"""bubble_kernels_s: the sum of the "polish: bubble kernels" steps per
job (the climb and the host work around it), s, the mean over the
traced window's jobs."""


def read(run):
    return run.step_mean(lambda name: name == "polish: bubble kernels")
