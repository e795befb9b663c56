"""What the host waited for the card in a packed train step: the summed
time of the program's ``sync.*`` spans under each ``train.step`` span,
per step, in ms. None when the window recorded no program span."""
from benchmark.harness.program_spans import Steps


def read(run):
    return Steps(run, "train.step").ms(prefix="sync.")
