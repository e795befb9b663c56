"""The blocking host-device copies of a packed train step: the program's
``sync.*`` spans under each ``train.step`` span in the traced window,
per step. None when the window recorded no program span."""
from benchmark.harness.program_spans import Steps


def read(run):
    return Steps(run, "train.step").count("sync.")
