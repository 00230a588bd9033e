"""One run of one cell: find its pieces, check the cards, hand the cell to
its traffic's driver, read the metrics and print the result line."""

import json
import sys
from dataclasses import dataclass, field

from vtbench import registry

FORBIDDEN = ("jax", "jaxlib", "flax", "videotransformer_tpu")
EXIT_CHECKOUT, EXIT_NO_CARD, EXIT_FORBIDDEN = 2, 3, 4


def forbidden_modules(modules=None):
    """Top-level names in ``sys.modules`` that are jax, jaxlib, flax or the
    JAX package, compared whole (the port's name starts with the JAX
    package's)."""
    names = modules if modules is not None else list(sys.modules)
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclass
class Run:
    """What a driver hands back, and what the metric readers read."""
    cell: registry.Cell
    traced: bool
    setup_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    end_to_end: dict = field(default_factory=dict)   # name -> value
    checks: list = field(default_factory=list)       # compare.judge rows
    correct: bool = False
    chips: int = 1
    peak_bytes: int = 0
    spans: object = None       # spans.Spans of the untraced window
    trace: object = None       # tracing.Trace of the traced window
    work: dict = field(default_factory=dict)  # counts in the traced window
    counters: dict = field(default_factory=dict)
    busy_s: float = None       # device busy seconds, mean over the cards
    window_s: float = None
    breakdown: dict = None
    forbidden: list = field(default_factory=list)


def metric_values(run, root):
    """{name: {"value", "unit"}}: the cell's end-to-end metrics in an
    untraced run, its per-layer metrics (those whose reader finds something
    to read) in a traced one."""
    out = {}
    if not run.traced:
        for m in run.cell.end_to_end:
            value = run.setup_s if m["name"] == "setup_s" \
                else run.end_to_end.get(m["name"])
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out
    for m in run.cell.per_layer:
        value = registry.metric_reader(root, m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(run, root):
    from vtbench import devices

    device = devices.describe(run.chips, run.peak_bytes)
    if run.traced:
        device["busy_s"] = run.busy_s
        device["window_s"] = run.window_s
    line = {"correct": bool(run.correct), "attempted": run.attempted,
            "failed": run.failed, "metrics": metric_values(run, root),
            "device": device}
    if run.traced and run.breakdown is not None:
        line["breakdown"] = run.breakdown
    line["checks"] = {r["name"]: {"value": r["value"], "limit": r["limit"]}
                      for r in run.checks}
    return line


def main(args, root, started):
    try:
        cell = registry.cell(root, args.workload)
    except registry.CheckoutError as exc:
        print(f"vtbench: {exc}", file=sys.stderr)
        return EXIT_CHECKOUT
    from vtbench import devices

    try:
        devices.require(cell.chips)
    except devices.NoCard as exc:
        print(f"vtbench: {exc}", file=sys.stderr)
        return EXIT_NO_CARD
    print(f"vtbench: cards {devices.power_line()}", file=sys.stderr,
          flush=True)
    driver = registry.driver(cell.traffic["driver"])
    run = driver.run(cell, args, started)
    found = sorted(set(forbidden_modules()) | set(run.forbidden))
    if found:
        print(f"vtbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return EXIT_FORBIDDEN
    line = result_line(run, root)
    for r in run.checks:
        detail = f" ({r['detail']})" if r.get("detail") else ""
        print(f"check {r['name']}: {r['value']:.6g} limit {r['limit']:.6g}"
              f"{'' if r['ok'] else ' FAILED'}{detail}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
