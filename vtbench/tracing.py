"""The traced window: ``torch.profiler`` around part of a run, reduced to
what the per-layer metrics and the result line read.

``window`` starts the profiler (CPU and CUDA activities) after a throwaway
session, so that the profiler's own start-up stays out of the window, and
stops it after a synchronize. ``reduce`` turns the session into a
``Trace``: the device's operations (kernels, copies, memsets) as (name,
start, end) in seconds, the host's operations and the harness's
``record_function`` ranges likewise, the window's length on the host
clock, and the device's busy seconds (the union of its operations)."""

import contextlib
import time
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile


@dataclass
class Trace:
    window_s: float
    device: list = field(default_factory=list)   # (name, start s, end s)
    host: list = field(default_factory=list)     # (name, start s, end s)

    def busy_s(self, ops=None):
        """Seconds in which at least one of ``ops`` (all device operations
        by default) ran."""
        return sum(e - s for s, e in union(ops or self.device))

    def kernel_s(self, pred):
        """Summed seconds of the device operations whose name ``pred``
        accepts."""
        return sum(e - s for n, s, e in self.device if pred(n))


def union(ops):
    """The union of (name, start, end) intervals as sorted (start, end)."""
    out = []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@contextlib.contextmanager
def window(device):
    """Profile the body; yields a dict whose "trace" is set on exit."""
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        pass
    holder = {}
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    sync()
    prof = profile(activities=acts)
    prof.__enter__()
    with torch.profiler.record_function("vtbench.window"):
        t0 = time.perf_counter()
        try:
            yield holder
        finally:
            sync()
            t1 = time.perf_counter()
    prof.__exit__(None, None, None)
    holder["trace"] = reduce(prof, t0, t1)


def _events(prof):
    """(name, is_device, start ns, end ns) of every event of the session
    but the device-side copies of ``record_function`` ranges (they are
    the host's, not operations the device ran), from the profiler's event
    list."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.device_type == cuda, e.time_range.start * 1000,
             e.time_range.end * 1000) for e in prof.events()
            if not (e.device_type == cuda and e.is_user_annotation)]


def reduce(prof, t0, t1):
    device, host = [], []
    for name, is_device, s, e in _events(prof):
        (device if is_device else host).append((name, s / 1e9, e / 1e9))
    return Trace(window_s=t1 - t0, device=device, host=host)


def breakdown(trace, top=10):
    """{"device_ops": the ``top`` device operations by summed seconds,
    "idle_gaps": the ``top`` longest gaps between device operations in
    the window, each named by the innermost host range open at its
    start}."""
    per = {}
    for n, s, e in trace.device:
        per[n] = per.get(n, 0.0) + (e - s)
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    win = next(((s, e) for n, s, e in trace.host if n == "vtbench.window"),
               None)
    busy = union(trace.device)
    gaps = []
    if busy:
        lo = win[0] if win else busy[0][0]
        hi = win[1] if win else busy[-1][1]
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((a, b - a))
    gaps = sorted(gaps, key=lambda g: -g[1])[:top]
    named = []
    for start, length in gaps:
        best = None
        for n, s, e in trace.host:
            if s <= start < e and n != "vtbench.window" and (
                    best is None or s > best[1]):
                best = (n, s)
        named.append([best[0] if best else "no host range", length])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}
