"""The blocking host-device copies of a render step: the program's
``sync.*`` spans under each ``engine.step`` span in the traced window
(utils/profiling.py), per step. None when the window recorded no
program span."""
from benchmark.harness.program_spans import Steps


def read(run):
    return Steps(run, "engine.step").count("sync.")
