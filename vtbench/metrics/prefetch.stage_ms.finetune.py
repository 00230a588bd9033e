"""Host ms a batch of the port's ``prefetch.stage`` span in the traced
window: the host copy of the next batch into the pinned ring of
``device_prefetch`` (recorded on a card only)."""

from vtbench import inside


def read(run):
    return inside.summed_ms_per(run, ("prefetch.stage",), "prefetch.next")
