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
- the port's spans: nothing recorded and no ``record_function`` entered
  with no session (the cost of 100k such span sites printed, not
  asserted); inside a session the spans of two threads with their parents
  and ids, a cross-thread ``record``, the buffer starting again with the
  next session; ``to_trace_clock`` against the ``record_function`` copies
  of the main thread's spans (median within 50 µs) and a second thread's
  span placed between two main-thread markers; a tiny TimeSformer step and
  a tiny MaskFeat step recording ``trainer.step`` and its phases under one
  step id, their losses, gradients and parameters bit-identical with the
  recorder on and off.
"""

import collections
import importlib.util
import json
import os
import statistics
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

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


# ------------------------------------------------------------------ spans

def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _host_ranges(prof):
    """(name, start s, end s) of a finished session's host events, as the
    benchmark's trace holds them."""
    return [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]


def test_no_session_records_nothing_and_enters_no_range(monkeypatch):
    class Refused:
        def __init__(self, *args, **kwargs):
            raise AssertionError("record_function entered with no session")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Refused)
    before = profiling.RECORDER.spans()
    for k in range(1000):
        with profiling.span("off", id=k):
            with profiling.span("off.child", parent=k):
                pass
        profiling.record("off.cross", 0, 1, id=k)
    # one shared do-nothing object: a site allocates nothing
    assert profiling.span("a") is profiling.span("b", id=1, parent=2)
    assert profiling.RECORDER.spans() == before


def test_off_path_cost_of_a_span_site(capsys):
    """The mean cost of a span site with no session, printed (PERF.md
    quotes it); no timing is asserted."""
    before = profiling.RECORDER.spans()
    n = 100_000
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with profiling.span("off"):
            pass
    site = (time.perf_counter_ns() - t0) / n
    t0 = time.perf_counter_ns()
    for _ in range(n):
        pass
    loop = (time.perf_counter_ns() - t0) / n
    with capsys.disabled():
        print(f"\nspan site with no session: {site:.1f} ns mean over {n} "
              f"(the bare loop {loop:.1f} ns)")
    assert profiling.RECORDER.spans() == before


def test_spans_of_two_threads_with_parents_and_ids():
    profiling.RECORDER.spans()  # whatever an earlier session left
    marks = {}

    def worker():
        with profiling.span("worker", id=3):
            with profiling.span("worker.child"):
                pass
        profiling.record("cross", marks["t0"], time.perf_counter_ns(),
                         id=5, parent=9)

    with _session():
        with profiling.span("outer", id=7):
            marks["t0"] = time.perf_counter_ns()
            with profiling.span("inner"):
                th = threading.Thread(target=worker)
                th.start()
                th.join()
    spans = profiling.RECORDER.spans()
    by = {s.name: s for s in spans}
    assert sorted(by) == ["cross", "inner", "outer", "worker",
                          "worker.child"]
    assert len(spans) == 5
    main, other = threading.get_ident(), by["worker"].thread
    assert other != main
    assert {by[n].thread for n in ("outer", "inner")} == {main}
    assert {by[n].thread for n in ("worker.child", "cross")} == {other}
    got = {n: (s.parent, s.id) for n, s in by.items()}
    assert got == {"outer": (None, 7), "inner": ("outer", 7),
                   "worker": (None, 3), "worker.child": ("worker", 3),
                   "cross": (9, 5)}
    outer, inner = by["outer"], by["inner"]
    assert outer.start_ns <= inner.start_ns <= by["worker"].start_ns \
        <= by["worker.child"].start_ns <= by["worker"].end_ns \
        <= inner.end_ns <= outer.end_ns
    assert by["cross"].start_ns == marks["t0"] < by["cross"].end_ns
    assert all(s.events is None for s in spans)  # no card
    # read again after the session: the same spans; the next session's
    # first span starts the buffer again
    assert profiling.RECORDER.spans() == spans
    with _session():
        with profiling.span("again"):
            pass
    assert [s.name for s in profiling.RECORDER.spans()] == ["again"]


def test_spans_of_many_threads_at_once_are_all_kept():
    """More threads than cores record nested spans at once under a short
    switch interval: no span is lost, and each keeps its thread's parent
    and id."""
    profiling.RECORDER.spans()
    n_threads, per = 2 * (os.cpu_count() or 4), 100
    start = threading.Barrier(n_threads)

    def worker(k):
        start.wait(timeout=30)
        for _ in range(per):
            with profiling.span("stress", id=k):
                with profiling.span("stress.child"):
                    pass

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _session():
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    spans = profiling.RECORDER.spans()
    assert len(spans) == 2 * n_threads * per
    per_thread = collections.Counter((s.thread, s.id) for s in spans)
    assert sorted(per_thread.values()) == [2 * per] * n_threads
    assert {(s.parent, s.name) for s in spans} == {
        (None, "stress"), ("stress", "stress.child")}


def test_to_trace_clock_against_the_record_function_copies():
    profiling.RECORDER.spans()
    x = torch.randn(64, 64)

    def worker():
        with profiling.span("worker"):
            time.sleep(0.002)

    with _session() as prof:
        for k in range(40):
            with profiling.span("step", id=k):
                (x @ x).sum()
        with profiling.span("marker.a"):
            time.sleep(0.001)
        th = threading.Thread(target=worker)
        th.start()
        th.join()
        with profiling.span("marker.b"):
            time.sleep(0.001)
    ranges = _host_ranges(prof)
    mapped = profiling.to_trace_clock(profiling.RECORDER.spans(), ranges)
    steps = sorted(s.start_ns for s in mapped if s.name == "step")
    copies = sorted(a for n, a, _ in ranges if n == "step")
    assert len(steps) == len(copies) == 40
    gaps = [abs(s / 1e9 - c) for s, c in zip(steps, copies)]
    assert statistics.median(gaps) <= 50e-6
    (a,) = [r for r in ranges if r[0] == "marker.a"]
    (b,) = [r for r in ranges if r[0] == "marker.b"]
    (w,) = [s for s in mapped if s.name == "worker"]
    assert a[2] <= w.start_ns / 1e9 < w.end_ns / 1e9 <= b[1]
    # no copy of any span's name: no clock
    assert profiling.to_trace_clock(mapped, [("other", 0.0, 1.0)]) is None


def _tiny_trainer(objective, monkeypatch):
    from videotransformer_tpu_torch.models.maskfeat import MaskFeat
    from videotransformer_tpu_torch.models.timesformer import TimeSformer
    from videotransformer_tpu_torch.training import trainer as ptrainer

    if objective == "mim":
        monkeypatch.setattr(ptrainer, "build_model", lambda c: MaskFeat(
            img_size=32, num_frames=4, depth=4,
            embed_dim_mul=((1, 2.0), (3, 2.0)),
            atten_head_mul=((1, 2.0), (3, 2.0)),
            pool_q_stride_size=((1, 1, 2, 2), (3, 1, 2, 2)),
            feature_dim=216))
        frames = 4
    else:
        monkeypatch.setattr(ptrainer, "build_model", lambda c: TimeSformer(
            num_frames=2, img_size=32, embed_dims=64, num_heads=4,
            num_transformer_layers=2, attention_type=c.attention_type))
        frames = 2
    cfg = SimpleNamespace(
        objective=objective, arch="mvit" if objective == "mim"
        else "timesformer", attention_type="divided_space_time",
        num_class=10, num_frames=frames, img_size=32, optim_type="adamw",
        clip_grad=1.0, seed=0, mixup=False, eval_metrics="finetune",
        use_fp16=False)
    rng = np.random.RandomState(3)
    batch = {"raw_video": rng.randint(0, 256, (2, frames, 36, 48, 3),
                                      dtype=np.uint8)}
    if objective == "mim":
        markers = np.zeros((2, 8, 2), np.int32)
        markers[0, :2] = [[0, 1], [1, 1]]
        markers[1, 0] = [0, 0]
        batch.update(mask=(rng.rand(2, 2, 2, 2) > 0.3).astype(np.int32),
                     cube_marker=markers,
                     cube_count=np.array([2, 1], np.int32))
    else:
        batch["label"] = np.array([1, 7], np.int32)
    return (lambda: ptrainer.VideoTransformerTrainer(cfg, "cpu")), batch


@pytest.mark.parametrize("objective", ["supervised", "mim"])
def test_a_train_step_records_its_phases_bit_for_bit(objective,
                                                       monkeypatch):
    make, batch = _tiny_trainer(objective, monkeypatch)

    def step(on):
        trainer = make()
        prior = profiling.RECORDER.spans()
        if on:
            with _session():
                stats = trainer.train_step(batch, 1e-3, 0.05)
        else:
            stats = trainer.train_step(batch, 1e-3, 0.05)
        params = trainer.optimizer.params
        after = profiling.RECORDER.spans()
        if not on:  # nothing kept with the recorder off
            assert after == prior
        return (stats["loss"], {n: p.grad for n, p in params.items()},
                {n: p.detach() for n, p in params.items()}, after)

    loss_off, grads_off, params_off, _ = step(False)
    loss_on, grads_on, params_on, spans = step(True)
    assert torch.equal(loss_off, loss_on)
    assert sorted(grads_off) == sorted(grads_on)
    for n in grads_off:
        assert (grads_off[n] is None) == (grads_on[n] is None), n
        if grads_off[n] is not None:
            assert torch.equal(grads_off[n], grads_on[n]), n
        assert torch.equal(params_off[n], params_on[n]), n
    phases = {"trainer.augment", "trainer.forward", "trainer.backward",
              "trainer.optimizer"} | ({"trainer.hog"}
                                      if objective == "mim" else set())
    assert sorted(s.name for s in spans) == sorted(phases | {"trainer.step"})
    (top,) = [s for s in spans if s.name == "trainer.step"]
    assert (top.parent, top.id) == (None, 1)  # the step's global_step
    for s in spans:
        if s.name != "trainer.step":
            assert (s.parent, s.id) == ("trainer.step", 1), s.name
            assert top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns
