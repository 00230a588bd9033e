"""The hand-written kernels' bound time (B2, B4-B6 and MViT's pools, by
the model adapter's counts) over their traced device time, in %."""

from vtbench import readers


def read(run):
    return readers.kernels_roofline(run)
