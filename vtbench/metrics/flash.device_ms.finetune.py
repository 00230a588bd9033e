"""Device ms a traced step in the flash attention kernels (B5's forward,
B6's dq and dk/dv passes and its split sum: ``vtbench/flash.py``); None
where none ran."""

from vtbench import flash


def read(run):
    s = flash.device_s(run)
    return None if s is None else 1e3 * s / run.work["steps"]
