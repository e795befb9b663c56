"""The benchmark's plain reference: a frozen copy of the port's plain
forward (models/, ops/, camera.py), its flop counter (utils/flops.py),
and what the benchmark derives again from the same inputs (the static
hints and the freeze mask, the gradient by autograd, the engine's seed
sequence and blend, the live lanes' flops).

Nothing here imports the program: the correctness check and the
rooflines measure the program against this copy, so a change to the
program cannot move them.
"""
