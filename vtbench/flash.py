"""The flash attention kernels' device time in a traced window: B5's
forward and B6's two passes and split sum, by their names in the port
(``csrc/flash_fwd.cuh``, ``csrc/flash_bwd.cuh``). B1's and B3's long
variant run the same kernels in place, so in a cell whose joint attention
is fused this time is theirs too; the cells that read it run the unfused
form, where these kernels are B5's and B6's alone."""

KERNELS = ("vt::flash_fwd_kernel", "vt::flash_dq_kernel",
           "vt::flash_dkdv_kernel", "vt::flash_sum_splits_kernel")


def is_flash(name):
    return name.removeprefix("void ").startswith(KERNELS)


def device_s(run):
    """Seconds of the traced window in the flash kernels; None without a
    traced window or where none ran."""
    if run.trace is None or not run.work.get("steps"):
        return None
    s = run.trace.kernel_s(is_flash)
    return s if s > 0 else None
