"""A run with the timed path broken underneath comes out not correct:
each fault the cells can have, planted in the program at tiny sizes on
the CPU, through the harness's whole run but its look for a card."""

import time
from types import SimpleNamespace

import pytest
import torch

from vtbench.tests import tiny
from vtbench.tests.conftest import run_cell


def _unchanged_step(self, lr, wd):
    """The optimizer's step that leaves the state as it was."""
    self.step_count += 1
    return self._clipped_grads(list(self.params))[1]


def _half_batch(monkeypatch):
    from videotransformer_tpu_torch.training.trainer import (
        VideoTransformerTrainer)

    real = VideoTransformerTrainer.train_step

    def half(self, batch, lr, wd):
        n = batch["raw_video"].shape[0] // 2
        return real(self, {k: v[:n] for k, v in batch.items()}, lr, wd)
    monkeypatch.setattr(VideoTransformerTrainer, "train_step", half)


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.mim"])
@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_a_broken_train_step_is_not_correct(tiny_root, on_cpu, monkeypatch,
                                            cell, fault):
    from videotransformer_tpu_torch.training import optimizer

    if fault == "unchanged":
        monkeypatch.setattr(optimizer.RefOptimizer, "step", _unchanged_step)
    else:
        _half_batch(monkeypatch)
    rc, line, _ = run_cell(tiny_root, cell)
    assert rc == 0
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_an_altered_answer_is_not_correct(tiny_root, on_cpu, monkeypatch):
    from vtbench.drivers import serve

    real = serve.TimedPredictor.__call__

    def altered(self, clips):
        out = real(self, clips)
        out[0] = out[0][::-1].copy()
        return out
    monkeypatch.setattr(serve.TimedPredictor, "__call__", altered)
    rc, line, _ = run_cell(tiny_root, "tiny.serve")
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["logits"]["value"] > \
        line["checks"]["logits"]["limit"]


@pytest.mark.parametrize("prepare,correct", [
    (tiny.prepare, True), (tiny.prepare_no_exchange, False)])
def test_data_parallel_over_four_processes(tiny_root, monkeypatch, prepare,
                                           correct):
    """Four gloo ranks on the CPU against the one-process reference on the
    global batch; without the gradient exchange the run is not correct."""
    from videotransformer_tpu_torch.training import optimizer, trainer
    from vtbench import devices, registry
    from vtbench.drivers import train

    # what ``prepare`` changes in this process (rank 0), put back after
    for obj, name in ((devices, "card"), (devices, "require"),
                      (trainer, "build_model"),
                      (optimizer, "all_reduce_coalesced")):
        monkeypatch.setattr(obj, name, getattr(obj, name))
    before = torch.get_num_threads()
    prepare()
    try:
        cell = registry.cell(tiny_root, "tiny.dp")
        args = SimpleNamespace(workload="tiny.dp", seed=3000000077,
                               seconds=1.0, trace=0)
        run = train.run(cell, args, time.perf_counter(), prepare=prepare)
    finally:
        torch.set_num_threads(before)
    assert run.correct is correct
    assert run.chips == 4 and run.attempted > 0
