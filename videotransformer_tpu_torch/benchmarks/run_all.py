"""Benchmark matrix of the port, one JSON line per config.

Twin of ``benchmarks/run_all.py`` (:1-349), with its configs and their
names:

1. TimeSformer-B divided 8x224 inference: clips/s over 10 reps of 4
   batches of 8, the p50 latency of a single clip (10 calls, each to a
   synchronize), the ms per single clip over 20 calls issued back to back
   (CUDA events), and the difference of the two (``dispatch_overhead_ms``);
2. the same for TimeSformer-B space_only and joint_space_time, and ViViT-B
   fact_encoder at 16 frames;
3. MViT-B supervised features (``forward_features[:, 0]``, 16x224) clips/s;
4. the eval steps of the trainer on 8 uint8 clips: val (CenterCrop) and
   test (ThreeCrop);
5. MaskFeat pretraining steps on MViT-B at batch 2 and 8;
6. supervised finetune steps (device augment, mixup, bf16, AdamW) at batch
   8, 16 and 32, with ``-remat`` from batch 32 (JAX's ``remat_from``),
   their TFLOP/s (3 x ``timesformer_fwd_flops``) and its share of the
   H100's 989 TFLOP/s dense bf16 peak.

JAX's ``lax.scan`` over batches is a host loop with one synchronize at the
end; steps are timed on the host clock over 5 after 2 of warm-up. On the
CPU (``--device cpu``) the CUDA-event and peak-share keys are None.
``--quick`` runs the headline config only.

    python -m videotransformer_tpu_torch.benchmarks.run_all [--quick] \\
        [--device cpu --model tiny]
"""

import argparse
import time

import numpy as np
import torch

from videotransformer_tpu_torch.benchmarks import common
from videotransformer_tpu_torch.training.trainer import (
    VideoTransformerTrainer)
from videotransformer_tpu_torch.utils.helpers import resolve_device

PEAK_BF16_TFLOPS = 989.0  # one H100 SXM, dense bf16 (NVIDIA's data sheet)
WD = 0.05


def timesformer_fwd_flops(B, T=8, img=224, D=768, H=12, layers=12, P=None):
    """Analytic forward FLOPs for TimeSformer-B divided space-time."""
    P = P or (img // 16) ** 2
    hd = D // H
    patch = 2 * B * T * P * (16 * 16 * 3) * D
    r_t = B * P * T
    r_s = B * T * (P + 1)
    r_f = B * (P * T + 1)
    temporal = 2 * r_t * D * 3 * D + 4 * B * P * H * T * T * hd + 2 * 2 * r_t * D * D
    spatial = 2 * r_s * D * 3 * D + 4 * B * T * H * (P + 1) ** 2 * hd + 2 * r_s * D * D
    ffn = 2 * r_f * D * 4 * D * 2
    return patch + layers * (temporal + spatial + ffn)


def train_rate(B, ms):
    """(TFLOP/s, its share of the H100's 989 TFLOP/s dense bf16 peak) of a
    TimeSformer-B finetune step of ``B`` clips in ``ms``: the forward and
    backward are 3x the forward's FLOPs (the usual convention)."""
    tflops = 3 * timesformer_fwd_flops(B) / 1e12 / (ms / 1000)
    return tflops, tflops / PEAK_BF16_TFLOPS


def _throughput(run, clips, device, reps=10):
    """Clips/s of ``reps`` calls of ``run`` (``clips`` each) after one,
    one synchronize at the end."""
    run()
    common.sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    common.sync(device)
    return clips * reps / (time.perf_counter() - t0)


def bench_inference(arch, attention_type, num_frames, name, model, device):
    batch, n_batches = 8, 4
    t, s = common.frames(model, num_frames), common.img_size(model)
    net, head = common.video_model(arch, attention_type, model, t, device)
    videos = torch.from_numpy(np.random.RandomState(0).rand(
        n_batches, batch, t, 3, s, s).astype(np.float32)).to(
            device, common.working_dtype(device))
    forward = torch.inference_mode()(lambda v: head(net(v)))
    clips = _throughput(lambda: [forward(v) for v in videos],
                        batch * n_batches, device)
    # p50 single-clip latency: each call to a synchronize
    one = videos[0][:1]
    forward(one)
    common.sync(device)
    lats = []
    for _ in range(10):
        t0 = time.perf_counter()
        forward(one)
        common.sync(device)
        lats.append(time.perf_counter() - t0)
    p50 = sorted(lats)[len(lats) // 2] * 1000
    # one clip's time with the calls issued back to back (CUDA events)
    device_ms = common.event_ms(lambda: forward(one), device, reps=20,
                                warmup=1) if device.type == "cuda" else None
    return {"config": name, "device": common.device_name(device),
            "clips_per_sec_per_chip": round(clips, 1),
            "p50_single_clip_ms": round(p50, 2),
            "device_ms_per_clip": None if device_ms is None
            else round(device_ms, 2),
            "dispatch_overhead_ms": None if device_ms is None
            else round(max(p50 - device_ms, 0), 2)}


def bench_mvit_inference(model, device):
    """MViT-B supervised features (forward_features[:, 0]), 16x224."""
    batch, n_batches = 4, 4
    t, s = common.frames(model, 16), common.img_size(model)
    net = common.mvit_model(model, device)
    videos = torch.from_numpy(np.random.RandomState(0).rand(
        n_batches, batch, t, 3, s, s).astype(np.float32)).to(
            device, common.working_dtype(device))
    forward = torch.inference_mode()(
        lambda v: net.forward_features(v)[:, 0])
    clips = _throughput(lambda: [forward(v) for v in videos],
                        batch * n_batches, device)
    return [{"config": "mvit_b_supervised_16f_224_infer",
             "device": common.device_name(device),
             "clips_per_sec_per_chip": round(clips, 1)}]


def bench_maskfeat_step(model, device, batch_sizes=(2, 8)):
    """MaskFeat pretraining steps, the HOG targets on the device."""
    cfg = common.maskfeat_configs(model, batch_sizes[0])
    with common.tiny_models(model):
        tr = VideoTransformerTrainer(cfg, device)
    rng = np.random.RandomState(0)
    lines = []
    for B in batch_sizes:
        batch = common.maskfeat_batch(rng, cfg, B, device)
        ms = common.clock_ms(lambda: tr.train_step(batch, 8e-4, WD), device)
        lines.append({"config": f"maskfeat_mvit_b_16f_224_pretrain_step_b{B}",
                      "device": common.device_name(device),
                      "ms_per_step": round(ms, 1),
                      "clips_per_sec": round(B / (ms / 1000), 1)})
    return lines


def bench_finetune_step(model, device, batch_sizes=(8, 16, 32),
                        remat_from=32):
    """The full supervised train step (device augment + mixup + forward
    and backward + AdamW); batches from ``remat_from`` on run with
    ``-remat``. A batch that does not fit gives an error line."""
    trainers = {}
    rng = np.random.RandomState(0)
    lines = []
    for B in batch_sizes:
        remat = B >= remat_from
        if remat not in trainers:
            cfg = common.finetune_configs(model, 8, remat=remat)
            with common.tiny_models(model):
                trainers[remat] = VideoTransformerTrainer(cfg, device)
        tr = trainers[remat]
        name = f"timesformer_b_8f_224_finetune_step_b{B}"
        batch = common.finetune_batch(rng, tr.configs, model, B, device)
        try:
            ms = common.clock_ms(lambda: tr.train_step(batch, 5e-3, WD),
                                 device)
        except torch.OutOfMemoryError as e:
            lines.append({"config": name, "error": type(e).__name__,
                          "message": str(e)[:300]})
            continue
        rate = train_rate(B, ms) if model == "b16" and \
            device.type == "cuda" else (None, None)
        lines.append({
            "config": name + ("_remat" if remat else "")
            + "_mixup_device_augment",
            "device": common.device_name(device),
            "ms_per_step": round(ms, 1),
            "clips_per_sec": round(B / (ms / 1000), 1),
            "train_tflops_per_sec": None if rate[0] is None
            else round(rate[0], 1),
            "train_mfu_vs_989tf_bf16_dense_peak": None if rate[1] is None
            else round(rate[1], 3)})
    return lines


def bench_eval_step(model, device, batch=8):
    """Val (CenterCrop) and test (ThreeCrop) eval steps on uint8 clips,
    the eval recipe on the device."""
    cfg = common.finetune_configs(model, batch)
    with common.tiny_models(model):
        tr = VideoTransformerTrainer(cfg, device)
    hb = common.finetune_batch(np.random.RandomState(0), cfg, model, batch,
                               device)
    lines = []
    for name, n_crops in (("val_center_crop", 1), ("test_three_crop", 3)):
        ms = common.clock_ms(lambda: tr.eval_step(hb, n_crops), device,
                             reps=10, warmup=1)
        lines.append({
            "config": f"timesformer_b_8f_224_eval_step_{name}_b{batch}",
            "device": common.device_name(device),
            "ms_per_step": round(ms, 1),
            "clips_per_sec": round(batch / (ms / 1000), 1)})
    return lines


def run(args, benches=None):
    """Run the matrix (``--quick``: the headline only; ``benches``: these
    names of ``BENCHES`` only) and return its JSON lines."""
    device = resolve_device(args.device)
    names = benches or (("divided",) if args.quick else tuple(BENCHES))
    lines = []
    for name in names:
        for line in BENCHES[name](args.model, device):
            common.emit(line)
            lines.append(line)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return lines


BENCHES = {
    "divided": lambda m, d: [bench_inference(
        "timesformer", "divided_space_time", 8,
        "timesformer_b_divided_8f_224_infer", m, d)],
    "space_only": lambda m, d: [bench_inference(
        "timesformer", "space_only", 8,
        "timesformer_b_space_only_8f_224_infer", m, d)],
    "joint": lambda m, d: [bench_inference(
        "timesformer", "joint_space_time", 8,
        "timesformer_b_joint_8f_224_infer", m, d)],
    "vivit": lambda m, d: [bench_inference(
        "vivit", "fact_encoder", 16, "vivit_b_fact_encoder_16f_224_infer",
        m, d)],
    "mvit": bench_mvit_inference,
    "eval": bench_eval_step,
    "maskfeat": bench_maskfeat_step,
    "finetune": bench_finetune_step,
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--quick", action="store_true",
                   help="headline configs only")
    p.add_argument("--device", default="cuda")
    p.add_argument("--model", choices=("b16", "tiny"), default="b16")
    return p.parse_args(argv)


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
