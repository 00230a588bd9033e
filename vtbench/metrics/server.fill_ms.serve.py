"""Mean host ms of the port's ``server.fill`` span in the traced window:
the server's batching window, from a batch's first request until the
batch is full or the window has passed."""

from vtbench import inside


def read(run):
    return inside.mean_ms(run, "server.fill")
