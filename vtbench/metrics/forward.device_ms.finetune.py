"""Device ms a traced step of the port's ``trainer.forward`` phase (the
model's forward and its loss), from the CUDA events the span records on
the current stream."""

from vtbench import inside


def read(run):
    return inside.device_ms_per_step(run, "trainer.forward")
