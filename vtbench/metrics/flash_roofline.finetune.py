"""B5's and B6's bound time over their traced device time, in %: the
frozen counts of the calls a step makes (``flash_calls`` of the cell's
model adapter, from ``counts.b5``/``b6``) over the flash kernels' time
(``vtbench/flash.py``). None where the adapter counts no flash calls or
none ran."""

from vtbench import counts, flash


def read(run):
    calls = getattr(run.cell.model, "flash_calls", None)
    spent = flash.device_s(run)
    if calls is None or spent is None:
        return None
    w = run.work
    per_step = counts.total_bound_s(calls(
        run.cell.config, w["clips_per_card"] // w["steps"], backward=True))
    return 100.0 * per_step * w["steps"] / spent if per_step > 0 else None
