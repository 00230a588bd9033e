"""Device ms a traced step in the port's MViT pooling kernels (the kernels
named ``vt::mvit_pool*``: the blocks' q, k and v pools forward, their input
and weight gradients); None where none ran, as over a program whose pools
are library convolutions."""

PREFIX = "vt::mvit_pool"


def read(run):
    if run.trace is None or not run.work.get("steps"):
        return None
    s = run.trace.kernel_s(
        lambda n: n.removeprefix("void ").startswith(PREFIX))
    return 1e3 * s / run.work["steps"] if s > 0 else None
