"""The host's time getting K1 launched in a render step: the self time of
the program's ``k1.pack``, ``k1.upload`` and ``k1.launch`` spans (the
seeds' blocking copy, ``sync.seeds``, left out), per ``engine.step``,
in ms. None when the window recorded no program span."""
from benchmark.harness.program_spans import Steps


def read(run):
    return Steps(run, "engine.step").self_ms(("k1.pack", "k1.upload", "k1.launch"))
