"""Model FLOPs of the requests served in the traced window over the window
times the bf16 peak, in %."""

from vtbench import readers


def read(run):
    return readers.mfu(run)
