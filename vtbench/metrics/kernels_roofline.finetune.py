"""B1-B6's bound time over their traced device time, in %."""

from vtbench import readers


def read(run):
    return readers.kernels_roofline(run)
