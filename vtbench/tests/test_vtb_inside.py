"""The per-layer metrics that read the program's own spans, on the CPU: a
traced tiny cell reports each host-span metric, and none of those the
program records on a card alone (CUDA events, runtime calls, the pinned
ring of the prefetch)."""

import pytest

from vtbench.tests.conftest import run_cell

HOST = ("server.queue_ms.serve", "predictor.upload_ms.serve",
        "device.idle_host.serve", "server.fill_ms.serve",
        "predictor.fetch_ms.serve")
_TRAIN = ("trainer.runtime_ms", "trainer.sync_ms", "forward.device_ms",
          "backward.device_ms", "prefetch.stage_ms", "prefetch.event_wait_ms")
DEVICE = {"tiny.serve": (),
          "tiny.train": tuple(f"{m}.finetune" for m in _TRAIN) + (
              "augment.device_ms.finetune", "optimizer.device_ms.finetune"),
          "tiny.mim": tuple(f"{m}.pretrain" for m in _TRAIN) + (
              "hog.device_ms.pretrain",)}


@pytest.mark.parametrize("cell", sorted(DEVICE))
def test_a_traced_tiny_cell_reads_the_programs_spans(tiny_root, on_cpu,
                                                     cell):
    rc, line, _ = run_cell(tiny_root, cell, trace=1)
    assert rc == 0 and line["correct"] is True
    metrics = line["metrics"]
    for name in DEVICE[cell]:
        assert name not in metrics
    if cell == "tiny.serve":
        for name in HOST:
            assert metrics[name]["value"] is not None, name
        assert metrics["server.queue_ms.serve"]["value"] > 0
        assert metrics["predictor.upload_ms.serve"]["value"] > 0
        assert metrics["server.fill_ms.serve"]["value"] > 0
        assert metrics["predictor.fetch_ms.serve"]["value"] > 0
        assert 0 < metrics["device.idle_host.serve"]["value"] \
            <= metrics["device.idle.serve"]["value"]
    else:
        assert not set(HOST) & set(metrics)
