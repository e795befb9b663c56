"""The view groups whose launch inputs a render step built anew: the
program's ``k1.pack`` spans under each ``engine.step`` span in the traced
window (utils/profiling.py), per step. A program that packs every group's
params every step reads the number of groups (2 in the render cells); one
that keeps them while the pose and the scene hold reads about 0. None when
the window recorded no program span."""
from benchmark.harness.program_spans import Steps


def read(run):
    return Steps(run, "engine.step").count("k1.pack")
