"""roofline.chain_dp: K1's roofline share, %: the sum over the traced
window's K1 launches of each launch's bound (`roofline/chain_dp.py`,
from that launch's own inputs) over the sum of their device times (the
profiler's chain_dp_kernel rows).  None without a launch."""


def read(run):
    bound_s = run.bound_s("chain_dp")
    dev_s = run.kernel_s("chain_dp_kernel")
    if bound_s is None or dev_s <= 0:
        return None
    return 100.0 * bound_s / dev_s
