"""Host ms a traced step in CUDA runtime and driver calls that issue work
or set it up (launches, copies, memsets, event records: the trace's
``cuda*`` and ``cu*`` host events but ``*Synchronize`` and ``*Query``),
every thread's, inside the port's ``trainer.step`` ranges. A launch held
back by a full launch queue counts here, as a long launch."""

from vtbench import inside


def read(run):
    return inside.runtime_ms_per_step(run, wait=False)
