"""The harness end to end on the CPU at tiny sizes: the pieces found by
name, the result line's form, the refusals."""

import json
import os
import subprocess
import sys

import pytest

from vtbench import harness, registry
from vtbench.tests import tiny
from vtbench.tests.conftest import run_cell

REPO = tiny.REPO


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_configuration_mix_and_metric_loads_by_name():
    bench = _bench()
    for w in bench["workloads"]:
        cell = registry.cell(REPO, w["name"])
        assert cell.config["name"] == w["config"]
        assert registry.driver(cell.traffic["driver"]).run
        for m in cell.per_layer:
            assert callable(registry.metric_reader(REPO, m["name"]))
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert os.path.exists(os.path.join(REPO, "vtbench", "limits",
                                           w["name"] + ".json"))
    for m in bench["per_layer"]:
        assert registry.metric_reader(REPO, m["name"])


def test_a_mix_and_a_metric_added_as_files(tmp_path):
    root = tiny.make_root(str(tmp_path))
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    with open(os.path.join(root, "vtbench", "traffic", "dummy.json"),
              "w") as f:
        json.dump({"driver": "train", "clips_per_step": 2}, f)
    with open(os.path.join(root, "vtbench", "metrics", "dummy.ms.py"),
              "w") as f:
        f.write("def read(run):\n    return 1.5\n")
    bench["workloads"].append({"name": "dummy.cell", "config": "tiny_tsf",
                               "traffic": "dummy", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "dummy.ms", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "x", "moves": "setup_s"})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    cell = registry.cell(root, "dummy.cell")
    assert cell.traffic["clips_per_step"] == 2
    assert [m["name"] for m in cell.per_layer] == ["dummy.ms"]
    assert registry.metric_reader(root, "dummy.ms")(None) == 1.5


@pytest.mark.parametrize("names,found", [
    (["videotransformer_tpu_torch", "videotransformer_tpu_torch.models"],
     []),
    (["jax.numpy"], ["jax"]),
    (["jaxlib"], ["jaxlib"]),
    (["flax.linen", "numpy"], ["flax"]),
    (["videotransformer_tpu.models"], ["videotransformer_tpu"]),
    (["jaxtyping", "flaxen", "videotransformer_tpu2"], []),
])
def test_forbidden_modules_compare_whole_names(names, found):
    assert harness.forbidden_modules(names) == found


def test_a_run_without_a_card_fails_and_prints_nothing(tiny_root):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "vtbench", "run.py"),
         "--workload", "tsf_b.finetune.b32", "--seed", "1", "--seconds",
         "1", "--trace", "0"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == harness.EXIT_NO_CARD
    assert proc.stdout.strip() == ""
    assert "cuda" in proc.stderr.lower()


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    """BENCHMARK.json and vtbench/ without the program: no result, and
    not a pass, even where the cards are there."""
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "vtbench"), tmp_path / "vtbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    code = ("import sys, torch; sys.path.insert(0, %r);"
            " from vtbench import devices;"
            " devices.require = lambda chips: None;"
            " devices.card = lambda rank=0: torch.device('cpu');"
            " from vtbench import run;"
            " sys.exit(run.main(['--workload', 'tsf_b.finetune.b32', '--seed',"
            " '1', '--seconds', '1', '--trace', '0'], root=%r))"
            % (str(tmp_path), str(tmp_path)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "videotransformer_tpu_torch" in proc.stderr


def test_nothing_loads_jax_or_the_jax_package():
    code = ("import sys, vtbench.run, vtbench.harness, vtbench.drivers.train,"
            " vtbench.drivers.serve, vtbench.calibrate, vtbench.sweep,"
            " vtbench.models.timesformer, vtbench.models.maskfeat_mvit;"
            " from vtbench import harness;"
            " print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("cell,trace", [
    ("tiny.train", 0), ("tiny.train", 1), ("tiny.mim", 0), ("tiny.serve", 1),
])
def test_a_tiny_cell_runs_correct(tiny_root, on_cpu, cell, trace):
    rc, line, _ = run_cell(tiny_root, cell, trace=trace)
    assert rc == 0
    assert line["correct"] is True and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    metrics = line["metrics"]
    if trace:
        assert "setup_s" not in metrics and metrics
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert metrics["setup_s"]["value"] > 0
        assert len(metrics) == 2


TWIN_ADAPTER = '''"""A third model, added as files: TimeSformer under another name, its
reference this checkout's ``reference/tsf_twin.py`` and its counts
TimeSformer's."""

import importlib.util
import os

from vtbench.models.timesformer import fwd_flops, kernel_calls  # noqa: F401

_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                     "reference", "tsf_twin.py")
_spec = importlib.util.spec_from_file_location("tsf_twin_reference", _path)
reference = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(reference)
'''
TWIN_REFERENCE = '''"""The twin's plain reference: the tiny TimeSformer's."""

from vtbench.reference.timesformer import (  # noqa: F401
    logits, param_specs, train_draws, train_loss)
'''


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_a_model_added_as_files_runs_correct(tmp_path, on_cpu):
    """A configuration naming a model the harness has never seen, its
    adapter, its reference and a cell, all new files and entries: the cell
    runs correct through run.py, its traced metrics read through the new
    adapter's counts, and no file that was there changes."""
    root = tiny.make_root(str(tmp_path))
    before = _tree(root)
    vt = os.path.join(root, "vtbench")
    with open(os.path.join(vt, "configs", "tiny_tsf.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny_twin", model="tsf_twin")
    files = {os.path.join("configs", "tiny_twin.json"): json.dumps(cfg),
             os.path.join("models", "tsf_twin.py"): TWIN_ADAPTER,
             os.path.join("reference", "tsf_twin.py"): TWIN_REFERENCE,
             os.path.join("limits", "twin.train.json"):
                 json.dumps(tiny.LIMITS)}
    for rel, text in files.items():
        os.makedirs(os.path.dirname(os.path.join(vt, rel)), exist_ok=True)
        with open(os.path.join(vt, rel), "w") as f:
            f.write(text)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_twin", "source": "tests",
                             "file": "vtbench/configs/tiny_twin.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "twin.train", "config": "tiny_twin",
                               "traffic": "tiny.train", "chips": 1,
                               "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny.train" in m.get("workloads", []):
            m["workloads"].append("twin.train")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = registry.cell(root, "twin.train")
    assert cell.model.reference.param_specs is \
        registry.model(tiny.REPO, "timesformer").reference.param_specs
    rc, line, _ = run_cell(root, "twin.train", trace=1)
    assert rc == 0
    assert line["correct"] is True and line["failed"] == 0
    assert line["metrics"]["mfu.finetune"]["value"] > 0
    after = _tree(root)
    changed = sorted(p for p, data in before.items()
                     if p != "BENCHMARK.json" and after.get(p) != data)
    assert changed == []


def test_an_unknown_model_is_refused_by_its_file(tmp_path, on_cpu):
    """A configuration whose model has no adapter: registry.model names
    the file it looked for, and a run of its cell exits as a checkout
    fault, printing no result."""
    root = tiny.make_root(str(tmp_path))
    want = os.path.join("vtbench", "models", "no_such_model.py")
    with pytest.raises(registry.CheckoutError, match=want):
        registry.model(root, "no_such_model")
    path = os.path.join(root, "vtbench", "configs", "tiny_tsf.json")
    with open(path) as f:
        cfg = json.load(f)
    with open(path, "w") as f:
        json.dump(dict(cfg, model="no_such_model"), f)
    rc, line, lines = run_cell(root, "tiny.train")
    assert rc == harness.EXIT_CHECKOUT and line is None and lines == []
