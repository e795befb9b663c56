"""The host's time inside each packed train step call (packing, the K4
launch, the mask, torch.optim.Adam), from the call to its return, as a
mean over the traced window, from the harness's own span around it."""


def read(run):
    spans = [t1 - t0 for name, t0, t1 in run.spans if name == "train.step"]
    return 1e3 * sum(spans) / len(spans) if spans else None
