"""The general drivers of the traffic mixes: ``serve`` (an open loop of
requests into the port's server) and ``train`` (train steps over the
port's prefetch, on one card or data-parallel over several). A traffic
file names its driver under ``"driver"``; everything else in it is the
driver's parameters."""

import threading


def prebuild_kernels(names):
    """Build the port's kernel libraries ``names`` at once, in threads (a
    build that is up to date only reads the files' times). The libraries
    go where the port puts them, inside the checkout."""
    from videotransformer_tpu_torch.kernels import _build

    errors = []

    def one(name):
        try:
            _build.build(name)
        except Exception as exc:  # raised below, with every failure
            errors.append(f"{name}: {exc}")

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("kernel builds failed:\n" + "\n".join(errors))
