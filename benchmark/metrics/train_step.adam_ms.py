"""The host's time in the optimizer in a packed train step: the program's
``train.adam`` spans (the gradient's zeroing, the freeze mask and
torch.optim.Adam's step), per ``train.step``, in ms. None when the
window recorded no program span."""
from benchmark.harness.program_spans import Steps


def read(run):
    return Steps(run, "train.step").ms(("train.adam",))
