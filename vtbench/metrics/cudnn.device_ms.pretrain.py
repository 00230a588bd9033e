"""Device ms a traced step in cuDNN's kernels (MViT's depthwise pools and
the patch embed)."""

from vtbench import readers


def read(run):
    return readers.device_ms_per_step(run, "cuDNN")
