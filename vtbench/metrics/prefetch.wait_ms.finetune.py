"""Mean host ms of each ``next()`` on ``device_prefetch`` in the untraced
window."""

from vtbench import readers


def read(run):
    return readers.span_ms(run, "vtbench.prefetch_next")
