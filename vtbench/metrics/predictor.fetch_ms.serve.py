"""Host ms a predictor call spends in the port's ``predictor.fetch`` span
in the traced window: ``.cpu().numpy()`` of the logits, which waits for
the device to finish the batch, over its ``predictor.call`` spans."""

from vtbench import inside


def read(run):
    return inside.summed_ms_per(run, ("predictor.fetch",), "predictor.call")
