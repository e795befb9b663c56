"""What the host waited for the card in a render step: the summed time of
the program's ``sync.*`` spans under each ``engine.step`` span, per step,
in ms. None when the window recorded no program span."""
from benchmark.harness.program_spans import Steps


def read(run):
    return Steps(run, "engine.step").ms(prefix="sync.")
