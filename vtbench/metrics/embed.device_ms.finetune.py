"""Device ms a traced step of the port's ``vivit.embed`` span (ViViT's
tubelet embedding, the cls row and the position and time tables), from
the CUDA events it records on the current stream; None where no such span
was recorded."""

from vtbench import inside


def read(run):
    return inside.device_ms_per_step(run, "vivit.embed")
