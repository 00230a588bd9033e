"""Mean requests a batch: the server's batch histogram
(``InferenceServer.stats.snapshot()``) at the untraced window's end."""


def read(run):
    hist = run.counters.get("batch_histogram") or {}
    n = sum(hist.values())
    return sum(int(k) * v for k, v in hist.items()) / n if n else None
