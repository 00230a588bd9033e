"""What the per-layer metric readers share: the grouping of device
operations by the code they come from, and the kernels' roofline and the
step's share of the peak from the frozen counts, which the cell's model
adapter gives (``vtbench/models/``).

``category`` is a frozen copy of ``utils/profiling.py::category`` of the
port (the program may change; the yardstick may not)."""

from vtbench import counts

_CUBLAS = ("nvjet", "cutlass", "xmma", "cublas", "gemv")


def category(name):
    """"port" (the hand-written kernels, namespace vt), "collective"
    (NCCL, gloo), "cuDNN", "cuBLAS" or "other"."""
    name = name.removeprefix("void ")
    low = name.lower()
    if name.startswith("vt::"):
        return "port"
    if "nccl" in low or "gloo" in low or low.startswith("c10d::"):
        return "collective"
    if "cudnn" in low or "convolve" in low:
        return "cuDNN"
    if any(k in low for k in _CUBLAS):
        return "cuBLAS"
    return "other"


def device_ms_per_step(run, cat):
    """Device ms a traced step in operations of category ``cat``."""
    if run.trace is None or not run.work.get("steps"):
        return None
    s = run.trace.kernel_s(lambda n: category(n) == cat)
    return 1e3 * s / run.work["steps"] if s > 0 else None


def kernel_bound_s(run):
    """Least time of the traced window's hand-written kernel calls, by the
    frozen counts: a train step's calls per traced step, or each served
    forward's at its bucket."""
    cfg, w, calls = run.cell.config, run.work, run.cell.model.kernel_calls
    if "buckets" in w:
        crops = cfg["serving"]["n_crops"]
        return sum(counts.total_bound_s(calls(cfg, b * crops,
                                              backward=False))
                   for b in w["buckets"])
    per_step = counts.total_bound_s(calls(
        cfg, w["clips_per_card"] // w["steps"], backward=True))
    return per_step * w["steps"]


def kernels_roofline(run):
    """The hand-written kernels' bound time over their traced device time,
    in %; None where no such kernel ran."""
    if run.trace is None:
        return None
    spent = run.trace.kernel_s(lambda n: category(n) == "port")
    if spent <= 0:
        return None
    return 100.0 * kernel_bound_s(run) / spent


def mfu(run):
    """Model FLOPs of the work completed in the traced window over the
    window times one card's bf16 peak, in %: served requests' forwards,
    or three forwards a clip stepped (no recompute), per card."""
    if run.trace is None or not run.trace.window_s:
        return None
    cfg, w, fwd_flops = run.cell.config, run.work, run.cell.model.fwd_flops
    if "requests_done" in w:
        flops = w["requests_done"] * fwd_flops(cfg,
                                               cfg["serving"]["n_crops"])
    else:
        flops = 3 * fwd_flops(cfg, w["clips_per_card"])
    if flops <= 0:
        return None
    return 100.0 * flops / (run.trace.window_s * counts.PEAK_BF16_FLOPS)


def idle(run):
    """Rank 0's card: 100 - its busy share of its traced window, %."""
    if run.trace is None or not run.trace.window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def span_ms(run, name):
    return None if run.spans is None else run.spans.mean_ms(name)
