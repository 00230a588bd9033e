"""Device ms a traced step of the port's ``trainer.backward`` phase
(``loss.backward()``), from the CUDA events the span records on the
current stream."""

from vtbench import inside


def read(run):
    return inside.device_ms_per_step(run, "trainer.backward")
