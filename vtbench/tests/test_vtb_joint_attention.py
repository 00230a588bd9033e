"""The reader of ``joint_attention.device_ms.finetune`` on synthetic
traced steps, on the CPU: the joint attention's forward in either form
(``attention.fused``, ``attention.unfused``) a step, so a program that
records only one of the two spans, as an older checkout does, reads on
the same number; nothing where neither span carries device events."""

import json
import os

import pytest

from vtbench import harness, inside, registry, tracing
from vtbench.tests import tiny

REPO = tiny.REPO
CELL = "vivit_b.finetune.b16"
NAME = "joint_attention.device_ms.finetune"


def _run():
    run = harness.Run(cell=registry.cell(REPO, CELL), traced=True)
    run.trace = tracing.Trace(window_s=1.0, device=[])
    run.work = {"steps": 2, "clips_per_card": 32, "backward": True}
    return run


def _span(name, events=None):
    from videotransformer_tpu_torch.utils import profiling

    return profiling.Span(name, 0, 1, 0, None, 1, events)


def test_the_metric_is_declared_for_the_cell():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        (m,) = [m for m in json.load(f)["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == [CELL]
    assert m["moves"] == "finetune_clips_per_s"
    assert NAME in {m["name"] for m in registry.cell(REPO, CELL).per_layer}


@pytest.mark.parametrize("fused,unfused,want", [
    (24, 0, 18.0),   # the fused call in every layer
    (0, 24, 24.0),   # the unfused form in every layer
    (12, 12, 21.0),  # both forms in one window
])
def test_the_reader_sums_both_forms(monkeypatch, fused, unfused, want):
    from videotransformer_tpu_torch.utils import profiling

    spans = ([_span("trainer.step")] * 2
             + [_span("attention.fused", 1.5)] * fused
             + [_span("attention.unfused", 2.0)] * unfused
             + [_span("vivit.embed", 0.75)] * 2)
    monkeypatch.setattr(inside, "recorded", lambda run: spans)
    monkeypatch.setattr(profiling, "device_ms", lambda s: s.events)
    assert registry.metric_reader(REPO, NAME)(_run()) == pytest.approx(want)


def test_the_reader_finds_nothing_without_device_events(monkeypatch):
    from videotransformer_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "device_ms", lambda s: s.events)
    read = registry.metric_reader(REPO, NAME)
    for spans in ([_span("trainer.step"), _span("attention.fused")],
                  [_span("trainer.step")], None):
        monkeypatch.setattr(inside, "recorded", lambda run: spans)
        assert read(_run()) is None
