"""The waves of K4's sweep: its blocks over the blocks the card holds at
once (resident blocks a SM times the SMs; the program's counter
``k4.sweep_waves`` inside ``k4.launch``), averaged over the traced
window's launches. None when the program records no such counter."""
from benchmark.harness.program_counters import mean


def read(run):
    return mean(run, "k4.sweep_waves")
