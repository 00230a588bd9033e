"""Host ms a traced step in CUDA runtime and driver calls that wait on the
device or poll it (``*Synchronize``, ``*Query``), every thread's, inside
the port's ``trainer.step`` ranges: what ``trainer.runtime_ms`` leaves
out."""

from vtbench import inside


def read(run):
    return inside.runtime_ms_per_step(run, wait=True)
