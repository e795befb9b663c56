"""The host's time in the tone map and the progressive blend of a render
step: the program's ``engine.tonemap`` and ``engine.blend`` spans, per
``engine.step``, in ms. None when the window recorded no program span."""
from benchmark.harness.program_spans import Steps


def read(run):
    return Steps(run, "engine.step").ms(("engine.tonemap", "engine.blend"))
