"""K4's sweep occupancy: the resident warps a SM of the sweep instance each
K4 launch runs, at its dynamic shared memory (the runtime's occupancy
query, the program's counter ``k4.resident_warps`` inside ``k4.launch``),
averaged over the traced window's launches. None when the program records
no such counter."""
from benchmark.harness.program_counters import mean


def read(run):
    return mean(run, "k4.resident_warps")
