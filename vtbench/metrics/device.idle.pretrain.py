"""100 - the share of the traced window in which the device ran an
operation, in %."""

from vtbench import readers


def read(run):
    return readers.idle(run)
