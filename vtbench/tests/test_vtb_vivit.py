"""ViViT joint space-time in the benchmark, on the CPU: the adapter's
counts against the paper and by hand, its refusals, a tiny ViViT cell
through ``run.py``, and the four readers of the cell's own metrics
(``flash.device_ms``, ``flash_roofline``, ``joint.device_ms``,
``embed.device_ms``) on a synthetic traced run and on the tiny cell,
where they find nothing to read (no card: no kernels, no CUDA events)."""

import json
import os

import pytest

from vtbench import counts, harness, inside, registry, tracing
from vtbench.tests import tiny
from vtbench.tests.conftest import run_cell

REPO = tiny.REPO
CELL = "vivit_b.finetune.b16"
CONFIG = "vivit_b16x2_joint_32x224"
NEW = ("flash.device_ms.finetune", "flash_roofline.finetune",
       "joint.device_ms.finetune", "embed.device_ms.finetune")
TINY = dict(num_frames=4, img_size=32, embed_dims=64, num_heads=2,
            num_transformer_layers=2, num_class=10, raw_hw=[36, 48])


def _config(**over):
    with open(os.path.join(REPO, "vtbench", "configs",
                           CONFIG + ".json")) as f:
        cfg = json.load(f)
    cfg.update(over)
    return cfg


def _adapter():
    return registry.model(REPO, "vivit")


def test_forward_flops_are_the_papers():
    """ViViT-B/16x2 joint at 32x224: 903.0 GFLOP a view by the count's
    formula, 451.5 G multiply-adds, within 1% of the paper's 455.2
    (Table 1, counted as multiply-adds)."""
    flops = _adapter().fwd_flops(_config(), 1)
    assert flops == pytest.approx(903.0e9, rel=1e-3)
    assert flops / 2 == pytest.approx(455.2e9, rel=0.01)
    assert _adapter().fwd_flops(_config(), 16) == 16 * flops


def test_forward_flops_by_hand():
    N, D, L = 3137, 768, 12
    layer = 8 * N * D * D + 4 * N * N * D + 16 * N * D * D
    patch = 2 * 16 * 196 * (2 * 16 * 16 * 3) * D
    assert _adapter().fwd_flops(_config(), 1) == \
        patch + L * layer + 2 * D * 400


@pytest.mark.parametrize("frames,tokens,flash", [(32, 3137, True),
                                                 (16, 1569, False)])
@pytest.mark.parametrize("backward", [False, True])
def test_kernel_calls_switch_to_flash_above_2048_tokens(frames, tokens,
                                                        flash, backward):
    cfg, a = _config(num_frames=frames), _adapter()
    calls = a.kernel_calls(cfg, 16, backward)
    ffn = [counts.b2(16 * tokens, 768, 3072)] + (
        [counts.b4(16 * tokens, 768, 3072)] if backward else [])
    if flash:
        shape = (16, 12, tokens, tokens, 64)
        attn = [counts.b5(*shape)] + ([counts.b6(*shape)] if backward
                                      else [])
    else:
        attn = [counts.b1(16, tokens, 768, heads=12)] + (
            [counts.b3(16, tokens, 768, heads=12)] if backward else [])
    assert sorted(calls) == sorted((attn + ffn) * 12)
    assert sorted(a.flash_calls(cfg, 16, backward)) == (
        sorted(attn * 12) if flash else [])
    assert a.FUSED_MHSA_MAX_N == 2048


def test_the_flash_bound_of_a_step():
    """B5 and B6 at (16, 12, 3137, 3137, 64) over 12 layers: 17.6 ms of
    bound a step, compute-bound."""
    calls = _adapter().flash_calls(_config(), 16, True)
    assert counts.total_bound_s(calls) == pytest.approx(17.6e-3, rel=0.01)
    assert all(f / counts.PEAK_BF16_FLOPS > b / counts.PEAK_HBM_BYTES
               for f, b in calls)


@pytest.mark.parametrize("kind", ["fact_encoder", "divided_space_time"])
@pytest.mark.parametrize("count", ["fwd_flops", "kernel_calls",
                                   "flash_calls"])
def test_the_adapter_refuses_other_attention_types(kind, count):
    cfg = _config(attention_type=kind)
    fn = getattr(_adapter(), count)
    with pytest.raises(ValueError, match=kind):
        fn(cfg, 16) if count == "fwd_flops" else fn(cfg, 16, True)


def test_the_cell_and_its_metrics_are_declared():
    cell = registry.cell(REPO, CELL)
    assert cell.chips == 1 and cell.config["model"] == "vivit"
    assert cell.traffic["clips_per_step"] == 16
    assert {m["name"] for m in cell.end_to_end} == {"finetune_clips_per_s",
                                                   "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert set(NEW) <= names and "allreduce.device_ms.finetune" not in names
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL], m["name"]


# ------------------------------------------------------------ the readers

def _traced_run(device=(), steps=2):
    run = harness.Run(cell=registry.cell(REPO, CELL), traced=True)
    run.trace = tracing.Trace(window_s=1.0, device=list(device))
    run.work = {"steps": steps, "clips_per_card": 16 * steps,
                "backward": True}
    return run


def _read(name, run):
    return registry.metric_reader(REPO, name)(run)


FLASH_TRACE = [
    ("void vt::flash_fwd_kernel<64>(CUtensorMap, CUtensorMap)", 0.0, 0.010),
    ("void vt::flash_dq_kernel<64>(CUtensorMap, CUtensorMap)", 0.010, 0.030),
    ("void vt::flash_dkdv_kernel<64>(CUtensorMap)", 0.030, 0.060),
    ("vt::flash_sum_splits_kernel(float const*, bf16*)", 0.060, 0.061),
    ("void vt::fused_ffn_fwd_kernel(CUtensorMap)", 0.061, 0.080),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN", 0.080, 0.090),
]


def test_the_flash_readers_on_a_traced_step():
    run = _traced_run(FLASH_TRACE)
    assert _read("flash.device_ms.finetune", run) == pytest.approx(30.5)
    bound = counts.total_bound_s(
        _adapter().flash_calls(_config(), 16, True)) * 2
    assert _read("flash_roofline.finetune", run) == pytest.approx(
        100 * bound / 0.061)


@pytest.mark.parametrize("device", [[], FLASH_TRACE[4:]])
def test_the_flash_readers_without_flash_kernels(device):
    run = _traced_run(device)
    assert _read("flash.device_ms.finetune", run) is None
    assert _read("flash_roofline.finetune", run) is None
    run.trace = None  # an untraced run
    assert _read("flash.device_ms.finetune", run) is None


def test_the_flash_roofline_of_a_model_without_flash_calls():
    run = _traced_run(FLASH_TRACE)
    run.cell = registry.cell(REPO, "tsf_b.finetune.b32")
    assert _read("flash.device_ms.finetune", run) == pytest.approx(30.5)
    assert _read("flash_roofline.finetune", run) is None


def _span(name, events=None):
    from videotransformer_tpu_torch.utils import profiling

    return profiling.Span(name, 0, 1, 0, None, 1, events)


def test_the_span_readers(monkeypatch):
    from videotransformer_tpu_torch.utils import profiling

    spans = [_span("trainer.step")] * 2 + [
        _span("attention.unfused", 1.5)] * 24 + [
        _span("vivit.embed", 0.75)] * 2
    monkeypatch.setattr(inside, "recorded", lambda run: spans)
    monkeypatch.setattr(profiling, "device_ms", lambda s: s.events)
    run = _traced_run()
    assert _read("joint.device_ms.finetune", run) == pytest.approx(18.0)
    assert _read("embed.device_ms.finetune", run) == pytest.approx(0.75)
    # spans without device events (the CPU), or a program without them
    for kept in ([s._replace(events=None) for s in spans], spans[:2]):
        monkeypatch.setattr(inside, "recorded", lambda run: kept)
        assert _read("joint.device_ms.finetune", run) is None
        assert _read("embed.device_ms.finetune", run) is None


# ------------------------------------------------------------ a tiny cell

def _tiny_vivit(c, mesh=None):
    from videotransformer_tpu_torch.models.vivit import ViViT

    return ViViT(num_frames=c.num_frames, img_size=c.img_size,
                 embed_dims=TINY["embed_dims"], num_heads=TINY["num_heads"],
                 num_transformer_layers=TINY["num_transformer_layers"],
                 attention_type=c.attention_type, mesh=mesh)


@pytest.fixture
def vivit_root(tmp_path):
    """A tiny checkout with a tiny ViViT joint configuration and the cell
    tiny.vivit (the b16 mix at 4 clips), beside the tiny cells."""
    root = tiny.make_root(str(tmp_path))
    vt = os.path.join(root, "vtbench")
    cfg = _config(name="tiny_vivit", **TINY)
    cfg["trainer"].update(num_class=10, num_frames=4, img_size=32)
    with open(os.path.join(vt, "configs", "tiny_vivit.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(vt, "traffic", "finetune.b16.json")) as f:
        mix = json.load(f)
    mix.update(clips_per_step=4, trace_steps=2, warmup_steps=1,
               reference_chunk=2)
    with open(os.path.join(vt, "traffic", "tiny.vivit.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(vt, "limits", "tiny.vivit.json"), "w") as f:
        json.dump(tiny.LIMITS, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_vivit", "source": "tests",
                             "file": "vtbench/configs/tiny_vivit.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tiny.vivit", "config": "tiny_vivit",
                               "traffic": "tiny.vivit", "chips": 1,
                               "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny.vivit")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture
def vivit_on_cpu(monkeypatch):
    """The harness on the CPU with the tiny ViViT, whose 9 tokens take the
    unfused joint attention under a cap of 8 (the published 3137 pass the
    port's 2048)."""
    import torch

    from videotransformer_tpu_torch.ops import blocks
    from videotransformer_tpu_torch.training import trainer as trainer_mod
    from vtbench import devices

    monkeypatch.setattr(devices, "card", lambda rank=0: torch.device("cpu"))
    monkeypatch.setattr(devices, "require", lambda chips: None)
    monkeypatch.setattr(trainer_mod, "build_model", _tiny_vivit)
    monkeypatch.setattr(blocks, "FUSED_MHSA_MAX_N", 8)
    calls = []
    real = blocks.JointAttention._unfused
    monkeypatch.setattr(blocks.JointAttention, "_unfused",
                        lambda self, *a: calls.append(1) or real(self, *a))
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield calls
    torch.set_num_threads(before)


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_vivit_cell_runs_correct(vivit_root, vivit_on_cpu, trace):
    from videotransformer_tpu_torch.utils import profiling

    rc, line, _ = run_cell(vivit_root, "tiny.vivit", trace=trace)
    assert rc == 0
    assert line["correct"] is True and line["failed"] == 0
    assert vivit_on_cpu  # the unfused branch ran
    metrics = line["metrics"]
    if not trace:
        assert set(metrics) == {"finetune_clips_per_s", "setup_s"}
        return
    assert metrics["mfu.finetune"]["value"] > 0
    # no card: no flash kernels in the trace and no CUDA events in the spans
    assert not set(NEW) & set(metrics)
    names = [s.name for s in profiling.RECORDER.spans()]
    steps = names.count("trainer.step")
    assert steps == 2
    assert names.count("vivit.embed") == steps
    assert names.count("attention.unfused") == 2 * steps
