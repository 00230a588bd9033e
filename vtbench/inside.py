"""What the per-layer metrics that read the program's own spans share.

The port records spans where its work happens (``utils/profiling.py`` of
the port: the server, the predictor, the trainer, the prefetch) while a
profiler session is active, so in a ``--trace 1`` run those of the traced
window. The readers take them from the recorder of this process, rank 0's,
once the window has closed, and put them on the trace's clock with the
port's ``profiling.to_trace_clock``. The benchmark also runs over older
checkouts of the program, whose ``profiling`` has no recorder: every
reader here then returns None."""

from videotransformer_tpu_torch.utils import profiling
from vtbench import tracing

# the collector's spans that are not its work: blocked on an empty queue,
# and each request's wait (recorded by the collector at dispatch)
_NOT_WORK = ("server.wait", "server.queue")


def recorded(run):
    """The port's spans of the traced window's session, or None (no traced
    window, or a program without the recorder)."""
    recorder = getattr(profiling, "RECORDER", None)
    if run.trace is None or recorder is None:
        return None
    return recorder.spans() or None


def _ms(s):
    return (s.end_ns - s.start_ns) / 1e6


def mean_ms(run, name):
    """Mean host ms of the program's spans ``name``."""
    got = [_ms(s) for s in recorded(run) or () if s.name == name]
    return sum(got) / len(got) if got else None


def summed_ms_per(run, names, per):
    """Host ms of the spans ``names`` summed, over the count of spans
    ``per``; None where no span ``names`` was recorded."""
    spans = recorded(run) or ()
    n = sum(1 for s in spans if s.name == per)
    got = [_ms(s) for s in spans if s.name in names]
    return sum(got) / n if got and n else None


def device_ms_per_step(run, name):
    """Device ms a traced step of the phase ``name``: its spans' CUDA event
    pairs summed, over the count of ``trainer.step`` spans; None where the
    spans carry no events (the CPU)."""
    spans = recorded(run) or ()
    steps = sum(1 for s in spans if s.name == "trainer.step")
    got = [profiling.device_ms(s) for s in spans if s.name == name]
    got = [v for v in got if v is not None]
    return sum(got) / steps if got and steps else None


def _overlap_s(a, b):
    """Seconds in both of two sorted lists of disjoint [start, end]."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def is_runtime_call(name):
    """A CUDA runtime (``cuda*``) or driver (``cu`` and a capital) call."""
    return name.startswith("cuda") or (
        name.startswith("cu") and name[2:3].isupper())


def is_wait_call(name):
    """A runtime or driver call that waits on the device or asks whether it
    has passed a point: ``*Synchronize``, ``*Query``. The rest issue
    work (launches, copies, memsets, event records) or set up."""
    return is_runtime_call(name) and (
        "Synchronize" in name or name.endswith("Query"))


def runtime_ms_per_step(run, wait):
    """Host ms a traced step in CUDA runtime and driver calls that wait
    (``wait``) or issue (not ``wait``), by ``is_wait_call``: the union of
    those host events of the trace, every thread's, inside its
    ``trainer.step`` ranges; None where the trace holds no runtime call
    (the CPU) or no such range."""
    if run.trace is None:
        return None
    steps = [h for h in run.trace.host if h[0] == "trainer.step"]
    calls = [h for h in run.trace.host if is_runtime_call(h[0])]
    if not steps or not calls:
        return None
    calls = [h for h in calls if is_wait_call(h[0]) == wait]
    inside = _overlap_s(tracing.union(steps), tracing.union(calls))
    return 1e3 * inside / len(steps)


def window(trace):
    """(start, end) s of the harness's ``vtbench.window`` range, which
    ``tracing.window`` opens around every traced window."""
    for n, s, e in trace.host:
        if n == "vtbench.window":
            return s, e
    raise LookupError("the trace holds no vtbench.window range")


def idle_host_share(run):
    """% of the traced window with no device operation while the server's
    collector thread was in one of its spans other than ``server.wait``
    (and the requests' ``server.queue``): every span on the trace's clock
    by ``to_trace_clock``."""
    spans = recorded(run)
    if spans is None or not run.trace.window_s:
        return None
    mapped = profiling.to_trace_clock(spans, run.trace.host)
    if mapped is None:
        return None
    collector = {s.thread for s in mapped if s.name == "server.wait"}
    work = tracing.union([(s.name, s.start_ns / 1e9, s.end_ns / 1e9)
                          for s in mapped if s.thread in collector
                          and s.name not in _NOT_WORK])
    lo, hi = window(run.trace)
    edges = [lo] + [x for iv in tracing.union(run.trace.device)
                    for x in iv] + [hi]
    idle = [[max(a, lo), min(b, hi)] for a, b in zip(edges[0::2], edges[1::2])
            if min(b, hi) > max(a, lo)]
    return 100.0 * _overlap_s(work, idle) / run.trace.window_s
