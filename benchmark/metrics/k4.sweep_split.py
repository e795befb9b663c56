"""K4's sample split: the chunks each pixel's samples are cut into, a
sweep block each, so that a small grid gives the card several waves of
blocks (the program's counter ``k4.sweep_split`` inside ``k4.launch``),
averaged over the traced window's launches. None when the program
records no such counter, as a program without the split does not."""
from benchmark.harness.program_counters import mean


def read(run):
    return mean(run, "k4.sweep_split")
