"""Model FLOPs of the traced steps (three forwards a clip) over the window
times the bf16 peak, in %."""

from vtbench import readers


def read(run):
    return readers.mfu(run)
