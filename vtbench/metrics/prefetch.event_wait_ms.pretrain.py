"""Host ms a batch of the port's ``prefetch.event_wait`` span in the
traced window: the pinned ring's wait for the copy that last read the
buffer set it is about to overwrite (recorded on a card only)."""

from vtbench import inside


def read(run):
    return inside.summed_ms_per(run, ("prefetch.event_wait",),
                                "prefetch.next")
