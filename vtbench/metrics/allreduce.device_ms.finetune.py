"""Device ms a traced step in collective kernels (NCCL) on rank 0."""

from vtbench import readers


def read(run):
    return readers.device_ms_per_step(run, "collective")
