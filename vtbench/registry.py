"""Find a cell's pieces by name: BENCHMARK.json's entries, the
configuration file, the model's adapter, the traffic file, the driver and
the per-layer metric readers. Nothing here names a cell, a configuration,
a model, a mix or a metric: a later change adds them as files and
entries."""

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field


class CheckoutError(Exception):
    """The checkout lacks BENCHMARK.json, a cell or one of its files."""


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    root: str = "."
    model: object = None  # the configuration's adapter (``model``)


def read_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise CheckoutError(f"{path}: not found") from None


def benchmark(root):
    return read_json(os.path.join(root, "BENCHMARK.json"))


def _for_cell(metric, cell, e2e_names):
    listed = metric.get("workloads")
    if listed is not None:
        return cell in listed
    moves = metric.get("moves")
    return moves is None or moves in e2e_names


def cell(root, name):
    """The cell ``name`` of ``root``'s BENCHMARK.json, its configuration
    and traffic read from their files, and the metrics it reports: an
    end-to-end metric without ``workloads`` is every cell's; a per-layer
    one without ``workloads`` is every cell's that reports what it moves."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise CheckoutError(f"no workload {name!r} in BENCHMARK.json")
    conf = next((c for c in bench["configs"]
                 if c["name"] == entry["config"]), None)
    if conf is None:
        raise CheckoutError(f"no config {entry['config']!r}")
    e2e = [m for m in bench["end_to_end"]
           if m.get("workloads") is None or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"] if _for_cell(m, name, names)]
    config = read_json(os.path.join(root, conf["file"]))
    return Cell(name=name, config_name=entry["config"],
                traffic_name=entry["traffic"], chips=int(entry["chips"]),
                config=config, traffic=traffic(root, entry["traffic"]),
                end_to_end=e2e, per_layer=layers, root=root,
                model=model(root, config["model"]))


def traffic(root, name):
    return read_json(os.path.join(root, "vtbench", "traffic",
                                  f"{name}.json"))


def driver(name):
    """The general driver module of a traffic mix's ``driver`` key."""
    return importlib.import_module(f"vtbench.drivers.{name}")


def _load(root, kind, name, what):
    """The module ``vtbench/<kind>/<name>.py`` under ``root``, loaded from
    its file (so a checkout's own files are found, not the imported
    package's)."""
    path = os.path.join(root, "vtbench", kind, f"{name}.py")
    if not os.path.exists(path):
        raise CheckoutError(f"{path}: no {what} {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"vtbench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def model(root, name):
    """The adapter ``vtbench/models/<name>.py`` under ``root`` of a
    configuration's ``model`` (``vtbench/models/__init__.py`` says what it
    exposes)."""
    return _load(root, "models", name, "adapter for model")


def metric_reader(root, name):
    """``read`` of ``vtbench/metrics/<name>.py`` under ``root``."""
    return _load(root, "metrics", name, "reader for metric").read
