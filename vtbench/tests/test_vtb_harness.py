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
            " vtbench.drivers.serve, vtbench.calibrate, vtbench.sweep;"
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
