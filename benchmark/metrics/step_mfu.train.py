"""The whole train step's share of the fp32 peak: K4's flops (the copy's
autograd, live share) of every step in the traced window over the
window's length (Adam's few flops a step are left out)."""
from benchmark.harness import roofline


def read(run):
    if not run.steps:
        return None
    return roofline.peak_share_pct(run.k4_work()["flops"] * run.steps, run.profile.window_s)
