"""Device ms a traced step of the port's ``attention.unfused`` spans (the
forward of joint attention's unfused form: LayerNorm, qkv, the layout
copies, B5, the projection; one a layer), from the CUDA events each span
records on the current stream; None where no such span was recorded."""

from vtbench import inside


def read(run):
    return inside.device_ms_per_step(run, "attention.unfused")
