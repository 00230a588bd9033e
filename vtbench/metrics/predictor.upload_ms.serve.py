"""Host ms a predictor call spends getting its batch onto the device in
the traced window: the port's ``predictor.stage`` (padding and
concatenating on the host) and ``predictor.upload`` (the ``.to(device)``
of the raw batch) spans, summed, over its ``predictor.call`` spans."""

from vtbench import inside


def read(run):
    return inside.summed_ms_per(run, ("predictor.stage", "predictor.upload"),
                                "predictor.call")
