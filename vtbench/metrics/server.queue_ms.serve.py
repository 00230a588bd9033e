"""Mean host ms a request waits in the server's queue in the traced
window: the port's ``server.queue`` span, from its submit to the hand-off
of its batch to the predictor."""

from vtbench import inside


def read(run):
    return inside.mean_ms(run, "server.queue")
