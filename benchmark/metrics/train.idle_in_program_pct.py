"""The share of a train cell's device idle time that the program's host
work leaves: of the window's idle gaps, those that begin while the host
is inside one of the program's spans, in percent of all idle time (the
rest begins in the harness's loss read-back, final synchronise and
loop). None when the window recorded no program span."""
from benchmark.harness.program_spans import idle_in_program_pct


def read(run):
    return idle_in_program_pct(run)
