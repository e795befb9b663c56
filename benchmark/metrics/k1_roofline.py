"""K1's share of its roofline: the least time a step's launches could
take (each window's launch from the hinted copy's live-lane flops over
the fp32 peak, or its bytes over the memory rate) over K1's device time
per step in the traced window, K1 found by its kernel's name (one launch
per window a step)."""

KERNELS = ("forward_kernel",)


def read(run):
    launches = run.profile.kernels(KERNELS)
    if not launches:
        return None
    work = run.k1_work()
    steps = len(launches) / work["launches"]
    return 100.0 * work["bound_s"] * steps / run.profile.kernel_seconds(KERNELS)
