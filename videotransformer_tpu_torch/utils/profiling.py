"""Profiling and step timing of the port.

Port of ``videotransformer_tpu/utils/profiling.py`` with ``torch.profiler``
in place of ``jax.profiler``: ``trace`` around a region (a chrome trace
written into ``log_dir``), ``device_sync`` and ``StepTimer`` (the
reference's time / data_time accounting, model_trainer.py:172-179). Also
the device-time breakdown of ``benchmarks/trace_step.py:124-208`` over
torch.profiler's events:

- ``profile_spans`` / ``chrome_trace_spans``: the device's spans (name,
  start µs, end µs) of a finished session or of its chrome trace: on a
  card its kernels, copies and memsets; on the CPU the top-level CPU ops;
- ``category``: which code a span comes from: the port's kernels
  (``vt::``), cuBLAS, cuDNN, PyTorch's elementwise kernels, layout and
  copies (copies, ``cat``, transposes, memcpy), collectives (NCCL, gloo)
  and other; ``kernel_source`` folds the last four into "other";
- ``summarize``: device ms per call for each name, the summed time, and
  the busy and idle share of the traced device span;
- ``analyze``: prints and returns the breakdown by category and the top
  ops per step.

And the port's own spans, recorded where the work happens (the server,
the predictor, the trainer, the prefetch, ViViT's embedding and joint
attention's fused and unfused forms) while a ``torch.profiler`` session
is active, and at no other time:

- ``span(name, id=None, parent=None, device=None)``: a context manager
  around host work on one thread; ``record(name, start_ns, end_ns, ...)``
  an interval that begins on one thread and ends on another. With no
  session a span site costs one read of
  ``torch.autograd.profiler._is_profiler_enabled`` and returns a shared
  do-nothing context manager: no allocation, no ``record_function``.
- A span (``Span``) holds its name, start and end in
  ``time.perf_counter_ns()``, its thread, its parent (the enclosing
  span's name on its thread, unless given) and its id (the enclosing
  span's, unless given: a request's spans share the request's id, a
  train step's share ``global_step``). On a CUDA ``device`` it also holds
  a pair of timing events recorded on the current stream, whose
  ``device_ms`` is read once the device has passed them; nothing waits
  on them.
- While on, each span also opens a ``record_function`` of its name, so the
  spans of the thread that started the profiler appear in its trace
  (``torch.profiler`` records the ranges of that thread alone) and name
  the trace's idle gaps. ``to_trace_clock`` uses those copies to put
  every span, other threads' too, on the trace's clock.
- ``RECORDER`` keeps the spans in a bounded buffer (thread-safe) and hands
  them out with ``spans()`` once the session has ended; the first span of
  the next session starts the buffer again.
"""

import collections
import contextlib
import json
import os
import statistics
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile

CATEGORIES = ("port", "cuBLAS", "cuDNN", "elementwise", "layout/copy",
              "collective", "other")
_CUBLAS = ("nvjet", "cutlass", "xmma", "cublas", "gemv")
_COPY = ("memcpy", "copy", "transpose")
_COPY_OPS = ("aten::cat", "aten::contiguous", "aten::clone")
_ELEMENTWISE = ("elementwise", "multi_tensor_apply", "aten::_foreach_")
_ELEMENTWISE_OPS = (
    "aten::add", "aten::add_", "aten::sub", "aten::rsub", "aten::mul",
    "aten::mul_", "aten::div", "aten::div_", "aten::neg", "aten::exp",
    "aten::sqrt", "aten::gelu", "aten::relu", "aten::where", "aten::clamp",
    "aten::addcmul_", "aten::addcdiv_", "aten::lerp_")


def activities():
    """CPU, and CUDA where a card is visible."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir):
    """A torch.profiler session around the region, yielding the profiler;
    its chrome trace is written to ``log_dir``/trace.json. A throwaway
    session runs first, so that the profiler's start-up stays out of the
    traced window."""
    with profile(activities=activities()):
        pass
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def device_sync(x=None):
    """Wait for the card that ``x`` (a tensor, or the first tensor of a
    dict, list or tuple) lies on; nothing for a CPU tensor or None."""
    t = None if x is None else _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class StepTimer:
    """time / data_time accounting (reference model_trainer.py:172-231)."""

    def __init__(self):
        self.data_start = time.perf_counter()
        self.step_start = self.data_start
        self.data_time = 0.0
        self.step_time = 0.0

    def data_ready(self):
        now = time.perf_counter()
        self.data_time = now - self.data_start
        self.step_start = now

    def step_done(self, sync_on=None):
        if sync_on is not None:
            device_sync(sync_on)
        now = time.perf_counter()
        self.step_time = now - self.data_start
        self.data_start = now
        return {"time": round(self.step_time, 3),
                "data_time": round(self.data_time, 3)}


# ------------------------------------------------------------ the breakdown

def category(name):
    """The code a device span comes from, by its name (one of
    ``CATEGORIES``)."""
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
    if any(k in low for k in _COPY) or name in _COPY_OPS:
        return "layout/copy"
    if any(k in low for k in _ELEMENTWISE) or name in _ELEMENTWISE_OPS:
        return "elementwise"
    return "other"


def kernel_source(name):
    """Which code a device kernel comes from: "port" (csrc/: namespace
    vt), "cuDNN", "cuBLAS", else "other" (PyTorch's own kernels, memsets,
    copies, collectives)."""
    cat = category(name)
    return cat if cat in ("port", "cuDNN", "cuBLAS") else "other"


def _top_level(events):
    """Of (key, name, start, end) events, those not inside an earlier one
    of the same key (thread)."""
    out, open_end = [], {}
    for key, name, start, end in sorted(events, key=lambda e: (e[0], e[2])):
        if start >= open_end.get(key, float("-inf")):
            out.append((name, start, end))
            open_end[key] = end
    return out


def _annotation(e):
    return getattr(e, "is_user_annotation", False)


def _op_parent(e):
    """The nearest enclosing op of a CPU event, ``record_function`` ranges
    (the port's spans among them) passed over."""
    p = e.cpu_parent
    while p is not None and _annotation(p):
        p = p.cpu_parent
    return p


def profile_spans(prof, device, exclude=()):
    """The spans of a finished torch.profiler session on ``device``
    ("cuda": its CUDA events, user annotations and the names in
    ``exclude`` left out; "cpu": the top-level CPU ops, inside
    ``record_function`` ranges or not, as the chrome trace's ``cpu_op``
    events give them)."""
    if torch.device(device).type == "cuda":
        return [(e.name, e.time_range.start, e.time_range.end)
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.name not in exclude and not _annotation(e)]
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU
            and not _annotation(e) and _op_parent(e) is None]


def chrome_trace_spans(path, device):
    """``profile_spans`` of the chrome trace ``path`` that ``trace`` (or
    ``export_chrome_trace``) wrote."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    if torch.device(device).type == "cuda":
        return [(e["name"], e["ts"], e["ts"] + e.get("dur", 0))
                for e in events
                if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return _top_level([((e.get("pid"), e.get("tid")), e["name"], e["ts"],
                        e["ts"] + e.get("dur", 0))
                       for e in events if e.get("cat") == "cpu_op"])


def summarize(spans, n):
    """Over ``n`` calls (steps): {"per_name": {name: (ms per call, calls
    in all)}, "total_ms": the summed span time per call, "span_ms": first
    start to last end per call, "busy_ms": the time per call when at least
    one span runs (below the summed time where spans overlap, as kernels
    on several streams do), "busy_share" and "idle_share" of the span}.
    None without spans."""
    if not spans:
        return None
    ordered = sorted((start, end) for _, start, end in spans)
    busy, (lo, hi) = 0.0, ordered[0]
    first, last = ordered[0][0], max(end for _, end in ordered)
    for start, end in ordered[1:]:
        if start > hi:
            busy, lo = busy + hi - lo, start
        hi = max(hi, end)
    busy += hi - lo
    per_name = {}
    for name, start, end in spans:
        ms, calls = per_name.get(name, (0.0, 0))
        per_name[name] = (ms + (end - start) / 1e3 / n, calls + 1)
    share = busy / (last - first) if last > first else 1.0
    return {"per_name": per_name,
            "total_ms": sum(ms for ms, _ in per_name.values()),
            "span_ms": (last - first) / 1e3 / n, "busy_ms": busy / 1e3 / n,
            "busy_share": share, "idle_share": 1 - share}


def group(per_name, key):
    """``summarize``'s per-name times summed by ``key(name)``: {key: (ms
    per call, calls in all)}."""
    out = {}
    for name, (ms, calls) in per_name.items():
        k = key(name)
        k_ms, k_calls = out.get(k, (0.0, 0))
        out[k] = (k_ms + ms, k_calls + calls)
    return out


def analyze(spans, steps, top=20, out=print):
    """Print the device time per step by category (``category``) and the
    top ops, as trace_step.py:124-208 does, and return {"device_ms" (the
    summed span time), "busy_ms", "span_ms", "busy_share", "idle_share",
    "categories": {category: ms per step}, "top": [[name, ms per step,
    calls per step], ...]}; None when the trace holds no span (not
    measured)."""
    s = summarize(spans, steps)
    if s is None:
        out("no device events in the trace; not measured")
        return None
    total = s["total_ms"]
    cats = group(s["per_name"], category)
    out(f"device total: {total:.3f} ms/step (busy {s['busy_ms']:.3f}) over "
        f"a span of {s['span_ms']:.3f} ms/step (busy share "
        f"{s['busy_share']:.4f}, idle share {s['idle_share']:.4f})")
    for cat, (ms, calls) in sorted(cats.items(), key=lambda kv: -kv[1][0]):
        out(f"  {cat:34s} {ms:8.3f} ms/step ({100 * ms / total:4.1f}%) "
            f"{calls / steps:8.1f} calls/step")
    out("top ops:")
    ranked = sorted(s["per_name"].items(), key=lambda kv: -kv[1][0])[:top]
    for name, (ms, calls) in ranked:
        out(f"  {name[:76]:76s} {ms:8.3f} ms/step {calls / steps:6.1f}")
    return {"device_ms": total, "busy_ms": s["busy_ms"],
            "span_ms": s["span_ms"], "busy_share": s["busy_share"],
            "idle_share": s["idle_share"],
            "categories": {c: cats.get(c, (0.0, 0))[0] for c in CATEGORIES},
            "top": [[n, ms, calls / steps] for n, (ms, calls) in ranked]}


# ------------------------------------------------------------ spans

# parent: the enclosing span's name, or what the site gives (a request's
# server.queue span: its batch's id); events: None, or the (start, end)
# CUDA events of a span on a card
Span = collections.namedtuple(
    "Span", "name start_ns end_ns thread parent id events")

_CAPACITY = 1 << 16  # spans a session keeps; the oldest give way


class Recorder:
    """The spans of the current or last profiler session, oldest first, in
    a buffer of at most ``_CAPACITY``."""

    def __init__(self):
        self._spans = collections.deque(maxlen=_CAPACITY)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._open = False  # the buffer holds a session that may go on

    def stack(self):
        """This thread's open spans, (name, id) each, innermost last."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def keep(self, span):
        if not self._open:  # the first span since the last spans()
            with self._lock:
                if not self._open:
                    self._spans.clear()
                    self._open = True
        self._spans.append(span)

    def spans(self):
        """The spans kept. Once the session has ended they are its spans
        (with those of any session that ran since the last call), and the
        next session's first span starts the buffer again; inside a session,
        the spans so far."""
        with self._lock:
            if not _autograd_profiler._is_profiler_enabled:
                self._open = False
            return list(self._spans)


RECORDER = Recorder()


class _Off:
    """The span of a site while no session is active: nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("name", "id", "parent", "device", "start_ns", "range",
                 "start_event", "stack")

    def __init__(self, name, id, parent, device):
        self.name, self.id, self.parent, self.device = name, id, parent, device

    def __enter__(self):
        stack = self.stack = RECORDER.stack()
        if stack:
            up_name, up_id = stack[-1]
            if self.parent is None:
                self.parent = up_name
            if self.id is None:
                self.id = up_id
        stack.append((self.name, self.id))
        self.start_ns = time.perf_counter_ns()
        self.range = _autograd_profiler.record_function(self.name)
        self.range.__enter__()
        self.start_event = None
        if self.device is not None and self.device.type == "cuda":
            self.start_event = torch.cuda.Event(enable_timing=True)
            self.start_event.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        events = None
        if self.start_event is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            events = (self.start_event, end)
        self.range.__exit__(*exc)
        end_ns = time.perf_counter_ns()
        self.stack.pop()
        RECORDER.keep(Span(self.name, self.start_ns, end_ns,
                           threading.get_ident(), self.parent, self.id,
                           events))
        return False


def span(name, id=None, parent=None, device=None):
    """A span around the body while a profiler session is active (module
    doc); ``device``: a CUDA device whose current stream also gets the
    span's pair of timing events."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, id, parent, device)


def record(name, start_ns, end_ns, id=None, parent=None):
    """Keep the span ``name`` from ``start_ns`` to ``end_ns``
    (``time.perf_counter_ns()``), begun on another thread, while a session
    is active; its thread is the caller's."""
    if _autograd_profiler._is_profiler_enabled:
        RECORDER.keep(Span(name, start_ns, end_ns, threading.get_ident(),
                           parent, id, None))


def device_ms(s):
    """Device ms between a span's two events; None without events or
    before the device has passed the second."""
    if s.events is None or not s.events[1].query():
        return None
    return s.events[0].elapsed_time(s.events[1])


def _trace_offset_ns(spans, trace_host_ranges):
    """What to add to a ``perf_counter_ns`` time to put it on the clock of
    ``trace_host_ranges`` ((name, start s, end s)), in ns: the median of
    (copy's start - span's start) over the spans whose ``record_function``
    copies the trace holds. A name counts where the trace holds as many
    ranges of it as there are spans, paired in order of start; None where
    no name does."""
    starts = collections.defaultdict(list)
    for s in spans:
        starts[s.name].append(s.start_ns)
    copies = collections.defaultdict(list)
    for name, start, _ in trace_host_ranges:
        if name in starts:
            copies[name].append(start)
    diffs = []
    for name, mine in starts.items():
        theirs = copies.get(name)
        if theirs and len(theirs) == len(mine):
            diffs += [t * 1e9 - s
                      for s, t in zip(sorted(mine), sorted(theirs))]
    return statistics.median(diffs) if diffs else None


def to_trace_clock(spans, trace_host_ranges):
    """``spans`` with start_ns and end_ns on the clock of a trace's host
    ranges ((name, start s, end s), the host events of a finished
    session), which its device operations share: the spans of every
    thread, whether or not the trace holds their copies; None where no
    span's copies are there. The offset is ``_trace_offset_ns``'s."""
    off = _trace_offset_ns(spans, trace_host_ranges)
    if off is None:
        return None
    return [s._replace(start_ns=s.start_ns + off, end_ns=s.end_ns + off)
            for s in spans]
