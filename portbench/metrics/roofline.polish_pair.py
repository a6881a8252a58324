"""roofline.polish_pair: K2+K3's roofline share, %: the sum over the
traced window's launch pairs of the pair's bound
(`roofline/polish_pair.py`, each climb batch's pairs at its own
lengths) over the sum of the K2 and K3 kernels' device times (the
profiler's rows, graph replays included).  None without a pair."""


def read(run):
    bound_s = run.bound_s("polish_pair")
    dev_s = (run.kernel_s("polish_backward_kernel")
             + run.kernel_s("polish_forward_score_kernel"))
    if bound_s is None or dev_s <= 0:
        return None
    return 100.0 * bound_s / dev_s
