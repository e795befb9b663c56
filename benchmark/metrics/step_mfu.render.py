"""The whole render step's share of the fp32 peak: the live-lane flops
of every step's K1 launches in the traced window over the window's
length. It bounds K1's roofline share from the step's side: a change that
takes work off K1's path shows here."""
from benchmark.harness import roofline


def read(run):
    steps = len(run.steps)
    if not steps:
        return None
    return roofline.peak_share_pct(run.k1_work()["flops"] * steps, run.profile.window_s)
