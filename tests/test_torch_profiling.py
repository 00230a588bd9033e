"""The port's profiling helpers and measuring scripts, on the CPU.

- ``utils/profiling.py``: ``StepTimer``'s fields (the JAX StepTimer's);
  ``device_sync`` on CPU tensors; ``category`` and ``kernel_source`` on
  the names a card's trace gives (the port's ``vt::`` kernels, cuBLAS's
  nvjet, cuDNN, PyTorch's elementwise and copy kernels, memcpy, NCCL) and
  on CPU op names; ``summarize``/``analyze`` on synthetic spans (the
  categories sum to the device total, the busy share of a span with a
  gap) and on a CPU trace, read from the session and from its chrome
  trace alike.
- ``benchmarks/``: each twin's entry point once with ``--device cpu
  --model tiny``, its JSON lines with the JAX script's keys; run_all's
  FLOPs equal to JAX's ``timesformer_fwd_flops`` and its share taken of
  989 TFLOP/s; every entry point refuses a card that is not there.
"""

import importlib.util
import json
import os

import pytest
import torch

from videotransformer_tpu.utils.profiling import StepTimer as JStepTimer
from videotransformer_tpu_torch.benchmarks import (
    profile_train, run_all, serve_bench, trace_infer, trace_step)
from videotransformer_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--model", "tiny"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are tiny: torch's intra-op threads would only
    contend with the other test processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def test_step_timer_fields():
    timer, jtimer = profiling.StepTimer(), JStepTimer()
    timer.data_ready()
    out = timer.step_done(sync_on={"loss": torch.zeros(2)})
    jtimer.data_ready()
    assert set(out) == set(jtimer.step_done()) == {"time", "data_time"}
    assert out["time"] >= out["data_time"] >= 0
    assert timer.step_time >= timer.data_time >= 0
    assert timer.data_start >= timer.step_start


def test_device_sync_is_a_no_op_on_the_cpu():
    for x in (None, torch.ones(1), [torch.ones(1)], {"a": (torch.ones(1),)},
              {"n": 3}):
        profiling.device_sync(x)


NAMES = [
    ("void vt::(anonymous namespace)::fused_mhsa_fwd<64>(vt::Params)",
     "port", "port"),
    ("nvjet_tst_192x192_64x4_2x1_v_bz_coopA_TNT", "cuBLAS", "cuBLAS"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "cuBLAS", "cuBLAS"),
    ("void cudnn::cnn::conv3d_grouped_direct_kernel<float>", "cuDNN",
     "cuDNN"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<c10::BFloat16>>", "elementwise", "other"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<>",
     "elementwise", "other"),
    ("void at::native::unrolled_elementwise_kernel<"
     "at::native::direct_copy_kernel_cuda>", "layout/copy", "other"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<>",
     "layout/copy", "other"),
    ("Memcpy HtoD (Pinned -> Device)", "layout/copy", "other"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)", "collective",
     "other"),
    ("Memset (Device)", "other", "other"),
    ("void at::native::reduce_kernel<512, 1>", "other", "other"),
    ("aten::cat", "layout/copy", "other"),
    ("aten::add", "elementwise", "other"),
    ("aten::_foreach_mul_", "elementwise", "other"),
    ("aten::linear", "other", "other"),
]


@pytest.mark.parametrize("name,cat,source", NAMES)
def test_category_of_trace_names(name, cat, source):
    assert profiling.category(name) == cat
    assert profiling.kernel_source(name) == source


def test_analyze_synthetic_spans():
    # two steps: a port kernel, a cuBLAS product, an elementwise add and a
    # copy, with a gap of 10 us in each step
    spans = []
    for step in range(2):
        t = step * 100.0
        spans += [("void vt::k1", t, t + 40), ("nvjet_gemm", t + 40, t + 60),
                  ("elementwise_kernel add", t + 70, t + 80),
                  ("Memcpy DtoD (Device -> Device)", t + 80, t + 90)]
    printed = []
    out = profiling.analyze(spans, 2, out=printed.append)
    cats = out["categories"]
    assert set(cats) == set(profiling.CATEGORIES)
    assert abs(sum(cats.values()) - out["device_ms"]) <= 1e-12
    assert out["device_ms"] == pytest.approx(0.080)
    assert cats["port"] == pytest.approx(0.040)
    assert cats["cuBLAS"] == pytest.approx(0.020)
    assert cats["elementwise"] == cats["layout/copy"] == pytest.approx(0.010)
    # busy 160 us of the span 0..190 us
    assert out["span_ms"] == pytest.approx(0.095)
    assert out["busy_ms"] == pytest.approx(0.080)
    assert out["busy_share"] == pytest.approx(160 / 190)
    assert out["idle_share"] == pytest.approx(30 / 190)
    assert out["top"][0] == ["void vt::k1", pytest.approx(0.040), 1.0]
    assert printed[0].startswith("device total: 0.080 ms/step (busy 0.080)")
    assert profiling.analyze([], 1, out=printed.append) is None
    # kernels on two streams at once: summed 30 us, busy 20 us
    both = [("void vt::k1", 0.0, 20.0), ("cudnn_conv", 10.0, 20.0)]
    out = profiling.analyze(both, 1, out=printed.append)
    assert out["device_ms"] == pytest.approx(0.030)
    assert out["busy_ms"] == out["span_ms"] == pytest.approx(0.020)


def test_analyze_a_cpu_trace(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        for _ in range(2):
            y = torch.cat([x @ x, x + x])
            (y * 2).t().contiguous()
    live = profiling.profile_spans(prof, "cpu")
    read = profiling.chrome_trace_spans(str(tmp_path / "trace.json"), "cpu")
    assert sorted(n for n, _, _ in live) == sorted(n for n, _, _ in read)
    names = {n for n, _, _ in live}
    assert {"aten::matmul", "aten::cat", "aten::add"} <= names
    assert "aten::mm" not in names  # inside aten::matmul: not top-level
    a = profiling.analyze(live, 2, out=lambda *_: None)
    b = profiling.analyze(read, 2, out=lambda *_: None)
    assert a["device_ms"] == pytest.approx(b["device_ms"], rel=1e-3)
    assert a["categories"]["layout/copy"] > 0
    assert a["categories"]["elementwise"] > 0
    assert sum(a["categories"].values()) == pytest.approx(a["device_ms"])
    # a card's spans of a CPU run: none (not measured)
    assert profiling.profile_spans(prof, "cuda") == []


# ------------------------------------------------------------------ twins

STEP_KEYS = {"config", "device", "wall_ms_per_step", "event_ms_per_step",
             "device_ms_per_step", "busy_ms_per_step", "idle_share",
             "host_share", "categories_ms", "host_busy_ms_per_step"}


@pytest.mark.parametrize("config", ["finetune", "maskfeat", "inference"])
def test_trace_step_runs_on_the_cpu(config, tmp_path, capsys):
    out = trace_step.main(TINY + ["--config", config, "--batch", "2",
                                  "--steps", "2", "--trace_dir",
                                  str(tmp_path)])
    line, = _lines(capsys)
    want = STEP_KEYS | ({"cudnn_deterministic"} if config == "maskfeat"
                        else set())
    assert set(line) == want
    assert line["config"] == f"trace_step_{config}_b2"
    assert line["device"] == "cpu" and line["event_ms_per_step"] is None
    cats = out["analysis"]["categories"]
    assert sum(cats.values()) == pytest.approx(line["device_ms_per_step"])
    assert os.path.getsize(tmp_path / "trace.json") > 0
    again = trace_step.main(TINY + ["--config", config, "--steps", "2",
                                    "--trace_dir", str(tmp_path),
                                    "--analyze_only"])
    assert again["device_ms_per_step"] == pytest.approx(
        line["device_ms_per_step"], rel=1e-3)


@pytest.mark.parametrize("arch", ["timesformer", "mvit"])
def test_trace_infer_runs_on_the_cpu(arch, tmp_path, capsys):
    trace_infer.main(TINY + ["--arch", arch, "--batch", "2", "--scans", "2",
                             "--reps", "1", "--trace_dir", str(tmp_path)])
    line, = _lines(capsys)
    assert set(line) == {"config", "device", "clips_per_sec",
                         "device_ms_per_batch", "busy_ms_per_batch",
                         "idle_share", "categories_ms"}
    assert line["clips_per_sec"] > 0 and line["device_ms_per_batch"] > 0


def test_profile_train_runs_on_the_cpu(capsys):
    profile_train.main(TINY + ["--batch", "2"])
    line, = _lines(capsys)
    parts = {"fwd_train_ms", "fwd_eval_ms", "fwd_bwd_ms", "augment_ms",
             "mixup_ms", "opt_ms", "full_step_ms"}
    assert set(line) == {"config", "device", "timer"} | parts
    assert line["timer"] == "host_clock"
    assert all(line[k] > 0 for k in parts)


def test_serve_bench_runs_on_the_cpu(capsys):
    _, clip, answers, predictor = serve_bench.run(serve_bench.parse_args(
        TINY + ["--seconds", "1", "--concurrency", "4"]))
    warm, single, loaded = _lines(capsys)
    assert warm["config"] == "serving_warmup" and warm["input_mode"] == "raw"
    assert set(single) == {"config", "device", "p50_request_ms",
                           "p90_request_ms"}
    assert set(loaded) == {"config", "device", "clips_per_sec",
                           "p50_request_ms", "p99_request_ms",
                           "batch_histogram"}
    assert loaded["config"] == \
        "serving_timesformer_b_3crop_raw_concurrency4"
    hist = {int(k): v for k, v in loaded["batch_histogram"].items()}
    assert max(hist) <= 8 and loaded["clips_per_sec"] > 0
    # every answer is the predictor's own answer for the clip
    direct = predictor(clip[None])[0]
    assert len(answers) >= 21
    for a in answers:
        assert abs(a - direct).max() <= 1e-4 * abs(direct).max()


def test_run_all_runs_on_the_cpu(capsys):
    lines = run_all.main(TINY)
    assert lines == _lines(capsys)
    by_name = {ln["config"]: ln for ln in lines}
    assert list(by_name) == [
        "timesformer_b_divided_8f_224_infer",
        "timesformer_b_space_only_8f_224_infer",
        "timesformer_b_joint_8f_224_infer",
        "vivit_b_fact_encoder_16f_224_infer",
        "mvit_b_supervised_16f_224_infer",
        "timesformer_b_8f_224_eval_step_val_center_crop_b8",
        "timesformer_b_8f_224_eval_step_test_three_crop_b8",
        "maskfeat_mvit_b_16f_224_pretrain_step_b2",
        "maskfeat_mvit_b_16f_224_pretrain_step_b8",
        "timesformer_b_8f_224_finetune_step_b8_mixup_device_augment",
        "timesformer_b_8f_224_finetune_step_b16_mixup_device_augment",
        "timesformer_b_8f_224_finetune_step_b32_remat_mixup_device_augment"]
    infer = by_name["timesformer_b_divided_8f_224_infer"]
    assert set(infer) == {"config", "device", "clips_per_sec_per_chip",
                          "p50_single_clip_ms", "device_ms_per_clip",
                          "dispatch_overhead_ms"}
    assert infer["device_ms_per_clip"] is None  # not measured on the CPU
    step = lines[-1]
    assert set(step) == {"config", "device", "ms_per_step", "clips_per_sec",
                         "train_tflops_per_sec",
                         "train_mfu_vs_989tf_bf16_dense_peak"}
    assert step["train_mfu_vs_989tf_bf16_dense_peak"] is None


def test_run_all_quick_is_the_headline(capsys):
    lines = run_all.main(TINY + ["--quick"])
    assert [ln["config"] for ln in lines] == \
        ["timesformer_b_divided_8f_224_infer"]


def _jax_run_all():
    spec = importlib.util.spec_from_file_location(
        "jax_run_all", os.path.join(REPO, "benchmarks", "run_all.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_all_flops_and_the_h100_peak():
    jax_run_all = _jax_run_all()
    for B in (1, 8, 16, 32):
        assert run_all.timesformer_fwd_flops(B) == \
            jax_run_all.timesformer_fwd_flops(B)
    assert run_all.PEAK_BF16_TFLOPS == 989.0
    tflops, share = run_all.train_rate(8, 100.0)
    assert tflops == pytest.approx(
        3 * jax_run_all.timesformer_fwd_flops(8) / 1e12 / 0.1)
    assert share == pytest.approx(tflops / 989.0)


ENTRY_POINTS = {"trace_step": trace_step.main,
                "trace_infer": trace_infer.main,
                "profile_train": profile_train.main,
                "serve_bench": serve_bench.main, "run_all": run_all.main}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_refuse_a_missing_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](["--model", "tiny"])
