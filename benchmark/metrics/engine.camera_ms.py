"""The host's time building the view groups' cameras in a render step:
the self time of the program's ``engine.camera`` spans (their ``sync.*``
children, the copies to the card, left out), per ``engine.step``, in ms.
None when the window recorded no program span."""
from benchmark.harness.program_spans import Steps


def read(run):
    return Steps(run, "engine.step").self_ms(("engine.camera",))
