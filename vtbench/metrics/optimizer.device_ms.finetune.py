"""Device ms a traced step of the port's ``trainer.optimizer`` phase (the
clip and the AdamW update), from the CUDA events the span records on the
current stream."""

from vtbench import inside


def read(run):
    return inside.device_ms_per_step(run, "trainer.optimizer")
