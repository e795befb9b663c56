"""The host's time inside each ``RenderEngine.step_frames`` call, from
the call to its return (the launch is enqueued, not finished), as a mean
over the traced window, from the harness's own span around the call."""


def read(run):
    spans = [t1 - t0 for name, t0, t1 in run.spans if name == "engine.step_frames"]
    return 1e3 * sum(spans) / len(spans) if spans else None
