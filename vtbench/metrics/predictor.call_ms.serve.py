"""Mean host ms of a predictor call in the untraced window: the harness's
thin callable around the server's predictor, call to return (the call
returns numpy, so it ends when the device does)."""

from vtbench import readers


def read(run):
    return readers.span_ms(run, "vtbench.predict")
