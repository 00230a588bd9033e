"""The harness's own spans, recorded around its calls into the program's
layers (the program records none of its own yet).

A span is (name, start, end) on the host clock (``time.perf_counter``).
While the profiler runs, each span is also a ``record_function`` range,
so the trace's idle gaps can be named by the harness's layer. Spans are
kept in memory and read once the window has closed."""

import contextlib
import time

import torch


class Spans:
    def __init__(self, enabled=False, annotate=False):
        self.enabled = enabled
        self.annotate = annotate
        self.events = []

    @contextlib.contextmanager
    def span(self, name):
        if not self.enabled:
            yield
            return
        rf = torch.profiler.record_function(name) if self.annotate \
            else contextlib.nullcontext()
        with rf:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.events.append((name, t0, time.perf_counter()))

    def durations(self, name):
        """Seconds of each span ``name``."""
        return [e - s for n, s, e in self.events if n == name]

    def mean_ms(self, name):
        d = self.durations(name)
        return 1e3 * sum(d) / len(d) if d else None
