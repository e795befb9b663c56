"""K4's share of its roofline: the least time one call could take (the
hinted copy's flops by autograd, times the live share, over the fp32
peak, or its bytes over the memory rate) over the summed device time of
every kernel a K4 call launches (pass 1, the sweeps, the sum), per call
(one pass-1 launch a call)."""
from benchmark.harness import roofline

KERNELS = ("loss_cot_kernel", "sweep_kernel", "sum_parts_kernel")


def read(run):
    calls = run.profile.kernels(KERNELS[:1])
    if not calls:
        return None
    seconds = run.profile.kernel_seconds(KERNELS) / len(calls)
    work = run.k4_work()
    return roofline.share_pct(work["flops"], work["bytes"], seconds)
