"""Smoke run of the PyTorch/CUDA port (videotransformer_tpu_torch) on one
NVIDIA GPU: builds the hand-written kernels from csrc/ (four libraries, one
nvcc each, all started together), holds each against its plain PyTorch
version at the main paths' shapes, and drives the two main paths at
TimeSformer-B/16's full width (divided space-time, 8x224, 12 layers, 400
classes, random weights from a seed):

- serving: the predictor and the dynamic-batching server, bf16;
- training: three supervised AdamW steps of the trainer on a batch of 8
  clips (fp32 parameters, bf16 compute, DropPath 0.1), repeated from the
  same state with the plain versions patched in.

Each path runs with the launch counts set to 0 just before it and read just
after, and must have gone through its kernels.

    python3 chip_smoke.py

Needs a CUDA card, nvcc (CUDA_HOME, default /usr/local/cuda) and nothing
else outside this checkout. Any failure raises and exits non-zero. The line
before the last is the kernel report: for each kernel its launches in each
main path's run and per forward or step, its worst error, and
"ms"/"plain_ms", the CUDA-event time of its calls in one TimeSformer block
at the main path's shapes, with each measured phase under "phases". The
last line is {"ok": true, "device": {...}}. The whole run took 50-66 s of
command time on an H100 (the four builds included), so no path runs at a
cut depth.
"""

import json
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

from videotransformer_tpu_torch.data.transforms import eval_transform_clip
from videotransformer_tpu_torch.kernels import _build, fused_ffn, fused_mhsa
from videotransformer_tpu_torch.models import convert
from videotransformer_tpu_torch.models.convert import split_artifact_params
from videotransformer_tpu_torch.models.timesformer import (
    get_vit_base_patch16_224)
from videotransformer_tpu_torch.ops.blocks import ClassificationHead
from videotransformer_tpu_torch.serving.predictor import (
    TorchPredictor, make_predict_fn)
from videotransformer_tpu_torch.serving.server import InferenceServer
from videotransformer_tpu_torch.training import trainer as trainer_mod

SEED = 0
D, HEADS, FRAMES, IMG, CLASSES, DEPTH = 768, 12, 8, 224, 400, 12
CLIPS, CROPS = 8, 3
KERNEL_REL_TOL = 1e-2  # about two bf16 ulps of the output scale
SLICE_REL_TOL = 5e-2   # bf16 rounding flips compounded over 12 blocks
SERVER_REL_TOL = 1e-4  # batched vs single-clip forwards: same kernels, same
                       # roundings; only the patch embed's cuBLAS algorithm
                       # may change with the batch
MEAN, STD = (0.45,) * 3, (0.225,) * 3
TRAIN_CLIPS, TRAIN_STEPS, TRAIN_LR, TRAIN_WD = 8, 3, 1e-4, 0.05
# kernels vs plain versions, per train step: bf16 rounding flips through 12
# blocks and back, compounded by the updates. Two H100 runs showed at most
# 4.6e-3 (loss) and 8.4e-3 (grad norm, step 3); the bounds leave about 2x
# and 3.5x.
LOSS_REL_TOL = 1e-2
NORM_REL_TOL = 3e-2
LIBRARIES = ("fused_mhsa", "fused_ffn", "fused_mhsa_bwd", "fused_ffn_bwd")


def log(*a):
    print(*a, flush=True)


def timed_ms(fn, iters=20, warmup=3):
    """Mean device time of one call, from CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bf16_on_card(rng, shape, std, mean=0.0):
    a = rng.standard_normal(shape, dtype=np.float32) * std + mean
    return torch.from_numpy(a).to("cuda", torch.bfloat16)


# ------------------------------------------------------------ kernel phases

def kernel_phases(rng):
    """Each kernel at a main-path shape against its plain version run in
    fp32 from the same bf16 inputs; times in turns (plain, kernel, kernel,
    plain) from CUDA events."""
    H4 = 4 * D
    # (kernel, phase, shape, block_diag, module, called once per block on
    # the slice's main path); the packed layout is the JAX package's
    phases = [
        ("fused_prenorm_mhsa", "dense spatial (192, 197, 768)",
         (192, 197, D), 0, fused_mhsa, True),
        ("fused_prenorm_mhsa", "block-diagonal temporal (4704, 8, 768)",
         (4704, 8, D), 8, fused_mhsa, True),
        ("fused_prenorm_mhsa", "block-diagonal packed (42, 896, 768)",
         (42, 896, D), 8, fused_mhsa, False),
        ("fused_prenorm_ffn", "rows (37656, 768), hidden 3072",
         (37656, D), None, fused_ffn, True),
    ]
    report = []
    for name, label, shape, block_diag, mod, on_path in phases:
        x = bf16_on_card(rng, shape, 1.0)
        ln = [bf16_on_card(rng, (D,), 0.1, 1.0), bf16_on_card(rng, (D,), 0.1)]
        if mod is fused_mhsa:
            w = [bf16_on_card(rng, (3 * D, D), 0.02),
                 bf16_on_card(rng, (3 * D,), 0.02),
                 bf16_on_card(rng, (D, D), 0.02), bf16_on_card(rng, (D,), 0.02)]
            tail = (HEADS, (D // HEADS) ** -0.5, 1e-5, False, block_diag)
            kernel = lambda: fused_mhsa.fused_prenorm_mhsa(x, *ln, *w, *tail)
            plain_fn = fused_mhsa.fused_prenorm_mhsa_reference
        else:
            w = [bf16_on_card(rng, (H4, D), 0.02), bf16_on_card(rng, (H4,), 0.02),
                 bf16_on_card(rng, (D, H4), 0.02), bf16_on_card(rng, (D,), 0.02)]
            tail = (1e-5,)
            kernel = lambda: fused_ffn.fused_prenorm_ffn(x, *ln, *w, *tail)
            plain_fn = fused_ffn.fused_prenorm_ffn_reference
        plain32 = lambda: plain_fn(*[t.float() for t in (x, *ln, *w)], *tail)
        got = kernel()
        torch.cuda.synchronize()
        want = plain32()
        abs_err = (got.float() - want).abs().max().item()
        rel_err = abs_err / want.abs().max().item()
        assert torch.isfinite(got).all(), label
        assert rel_err <= KERNEL_REL_TOL, (label, rel_err)
        # the plain version as the main path would call it: bf16 operands
        plain = lambda: plain_fn(x, *ln, *w, *tail)
        p1, k1, k2, p2 = (timed_ms(plain), timed_ms(kernel), timed_ms(kernel),
                          timed_ms(plain))
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        log(f"kernel {name} [{label}]: max|kernel-plain|/max|plain| = "
            f"{rel_err:.3e} (tol {KERNEL_REL_TOL}), max abs {abs_err:.3e}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        report.append({"name": name, "phase": label, "on_path": on_path,
                       "max_abs_err": abs_err, "rel_err": rel_err, "ms": ms,
                       "plain_ms": plain_ms})
        del x, w, got, want
    return report


def backward_phases(rng):
    """Each backward kernel at a train-step shape (batch of 8 clips) against
    its plain backward run in fp32 from the same bf16 inputs: every output
    gradient within KERNEL_REL_TOL of max|plain| of that gradient. Times in
    turns (plain, kernel, kernel, plain): B3 alone (``_attn_bwd_launch``
    against ``_attn_bwd_reference``; the projection products around it are
    torch.matmul in both), B4 whole."""
    H4 = 4 * D
    phases = [
        ("fused_prenorm_mhsa_bwd", "dense spatial (64, 197, 768)",
         (64, 197, D), 0),
        ("fused_prenorm_mhsa_bwd", "block-diagonal temporal (1568, 8, 768)",
         (1568, 8, D), 8),
        ("fused_prenorm_ffn_bwd", "rows (12552, 768), hidden 3072",
         (12552, D), None),
    ]
    report = []
    for name, label, shape, block_diag in phases:
        x = bf16_on_card(rng, shape, 1.0)
        g = bf16_on_card(rng, shape, 1.0)
        ln = [bf16_on_card(rng, (D,), 0.1, 1.0), bf16_on_card(rng, (D,), 0.1)]
        if block_diag is not None:
            w = [bf16_on_card(rng, (3 * D, D), 0.02),
                 bf16_on_card(rng, (3 * D,), 0.02),
                 bf16_on_card(rng, (D, D), 0.02), bf16_on_card(rng, (D,), 0.02)]
            cfg = (HEADS, (D // HEADS) ** -0.5, 1e-5, False, block_diag)
            _, qkv, attn = fused_mhsa._launch(x, *ln, *w, *cfg)
            args = (g, x, qkv, attn, ln[0], ln[1], w[0], w[2])
            kernel_all = lambda: fused_mhsa._launch_backward(*args, *cfg)
            plain_all = fused_mhsa.fused_prenorm_mhsa_backward_reference
            do = (g.float().reshape(-1, D) @ w[2].float()).to(torch.bfloat16)
            core = (x, qkv, do, None, ln[0], w[0], *cfg[:3], block_diag)
            kernel = lambda: fused_mhsa._attn_bwd_launch(*core)
            plain = lambda: fused_mhsa._attn_bwd_reference(*core)
            tail = cfg
        else:
            w = [bf16_on_card(rng, (H4, D), 0.02), bf16_on_card(rng, (H4,), 0.02),
                 bf16_on_card(rng, (D, H4), 0.02), bf16_on_card(rng, (D,), 0.02)]
            _, h_pre = fused_ffn._launch(x, *ln, *w, 1e-5, True)
            args = (g, x, h_pre, ln[0], ln[1], w[0], w[2])
            tail = (1e-5,)
            kernel_all = kernel = lambda: fused_ffn._launch_backward(*args,
                                                                   *tail)
            plain_all = fused_ffn.fused_prenorm_ffn_backward_reference
            plain = lambda: plain_all(*args, *tail)
        got = kernel_all()
        torch.cuda.synchronize()
        want = plain_all(*[a.float() for a in args], *tail)
        abs_err = rel_err = 0.0
        for a, b in zip(got, want):
            assert torch.isfinite(a).all(), label
            e = (a.float() - b).abs().max().item()
            abs_err = max(abs_err, e)
            rel_err = max(rel_err, e / b.abs().max().item())
        assert rel_err <= KERNEL_REL_TOL, (label, rel_err)
        p1, k1, k2, p2 = (timed_ms(plain, iters=5, warmup=1),
                          timed_ms(kernel), timed_ms(kernel),
                          timed_ms(plain, iters=5, warmup=1))
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        whole = timed_ms(kernel_all, iters=10)
        log(f"kernel {name} [{label}]: worst max|kernel-plain|/max|plain| "
            f"over the gradients = {rel_err:.3e} (tol {KERNEL_REL_TOL}), "
            f"max abs {abs_err:.3e}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms; whole backward call {whole:.4f} ms")
        report.append({"name": name, "phase": label, "on_path": True,
                       "max_abs_err": abs_err, "rel_err": rel_err, "ms": ms,
                       "plain_ms": plain_ms})
        del x, g, w, got, want
    return report


# ---------------------------------------------------------------- profile

def profile_forward(forward, event_ms, n=3, what="forward"):
    """Device kernels of ``n`` calls of ``forward`` under ``torch.profiler``:
    device ms per call for each kernel name, the device's busy share between
    the first kernel's start and the last kernel's end, and the summed
    kernel time over ``event_ms`` (one call by CUDA events, unprofiled)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # first session: profiler start-up
        forward()
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(n):
            forward()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        log("profile: no device events in the trace; not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, (lo, hi) = 0.0, spans[0]
    first, last = spans[0][0], max(end for _, end in spans)
    for start, end in spans[1:]:
        if start > hi:
            busy, lo = busy + hi - lo, start
        hi = max(hi, end)
    busy += hi - lo
    per_name = {}
    for e in device:
        ms, calls = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (ms + (e.time_range.end - e.time_range.start)
                            / 1e3 / n, calls + 1)
    summed = sum(ms for ms, _ in per_name.values())
    log(f"profile ({n} x {what}): device kernel time {summed:.3f} ms per "
        f"{what} against {event_ms:.3f} ms by CUDA events unprofiled "
        f"(ratio {summed / event_ms:.3f}); busy share of the traced device "
        f"span {busy / (last - first):.4f}, idle share "
        f"{1 - busy / (last - first):.4f}")
    for name, (ms, calls) in sorted(per_name.items(),
                                    key=lambda kv: -kv[1][0])[:24]:
        log(f"  {ms:9.3f} ms  {calls // n:4d} calls  {name[:110]}")


# ---------------------------------------------------------------- the slice

def jax_style_params(rng):
    """TimeSformer-B/16 divided 8x224 + a 400-class head in the JAX
    package's flat artifact form ({"model/a/b": array}), std 0.02 (LayerNorm
    scales 1 + 0.02·N), temporal_fc nonzero."""
    def n(*shape, mean=0.0):
        return rng.standard_normal(shape, dtype=np.float32) * 0.02 + mean

    P = (IMG // 16) ** 2
    f = {"model/cls_token": n(1, 1, D), "model/pos_embed": n(1, P + 1, D),
         "model/time_embed": n(1, FRAMES, D),
         "model/patch_embed/projection/kernel": n(16, 16, 3, D),
         "model/patch_embed/projection/bias": n(D),
         "model/norm/scale": n(D, mean=1.0), "model/norm/bias": n(D),
         "head/cls_head/kernel": n(D, CLASSES), "head/cls_head/bias": n(CLASSES)}
    for i in range(DEPTH):
        pre = f"model/transformer_layers/layers_{i}"
        for a in (0, 1):
            ap = f"{pre}/attentions_{a}"
            f.update({f"{ap}/norm/scale": n(D, mean=1.0),
                      f"{ap}/norm/bias": n(D),
                      f"{ap}/attn/qkv/kernel": n(D, 3 * D),
                      f"{ap}/attn/qkv/bias": n(3 * D),
                      f"{ap}/attn/proj/kernel": n(D, D),
                      f"{ap}/attn/proj/bias": n(D)})
        f.update({f"{pre}/attentions_0/temporal_fc/kernel": n(D, D),
                  f"{pre}/attentions_0/temporal_fc/bias": n(D),
                  f"{pre}/ffns_0/norm/scale": n(D, mean=1.0),
                  f"{pre}/ffns_0/norm/bias": n(D),
                  f"{pre}/ffns_0/layers_0/kernel": n(D, 4 * D),
                  f"{pre}/ffns_0/layers_0/bias": n(4 * D),
                  f"{pre}/ffns_0/layers_1/kernel": n(4 * D, D),
                  f"{pre}/ffns_0/layers_1/bias": n(D)})
    return f


def build_slice(rng):
    model_sd, head_sd = split_artifact_params(jax_style_params(rng))
    model = get_vit_base_patch16_224(num_frames=FRAMES)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in model_sd.items()}, strict=True)
    head = ClassificationHead(CLASSES, D)
    head.load_state_dict({k: torch.from_numpy(v)
                          for k, v in head_sd.items()}, strict=True)
    manifest = {"num_frames": FRAMES, "num_class": CLASSES, "img_size": IMG,
                "n_crops": CROPS, "buckets": [1, 2, 4, 8],
                "input_mode": "clips"}
    # weights are cast once, here, to bf16 on the card; the head stays fp32
    return TorchPredictor(model, head, manifest, "cuda", torch.bfloat16)


# ---------------------------------------------------------------- training

KERNEL_COUNTERS = ((fused_mhsa, "LAUNCHES"), (fused_ffn, "LAUNCHES"),
                   (fused_mhsa, "BWD_LAUNCHES"), (fused_ffn, "BWD_LAUNCHES"))
KERNEL_NAMES = ("fused_prenorm_mhsa", "fused_prenorm_ffn",
                "fused_prenorm_mhsa_bwd", "fused_prenorm_ffn_bwd")


def reset_counts():
    for mod, attr in KERNEL_COUNTERS:
        setattr(mod, attr, 0)


def read_counts():
    return {n: getattr(mod, attr)
            for n, (mod, attr) in zip(KERNEL_NAMES, KERNEL_COUNTERS)}


def trainer_tree(flat):
    """The artifact-form params ({"model/a/b": array, "head/...": ...}) as
    the JAX trainer's parameter tree {"model": ..., "cls_head": ...}."""
    tree = convert.unflatten_tree(flat)
    return {"model": tree["model"], "cls_head": tree["head"]}


def train_configs():
    """The JAX trainer's TimeSformer default: supervised, AdamW, per-param
    clip 1.0, fp32 parameters with bf16 compute, DropPath 0.1."""
    return SimpleNamespace(
        objective="supervised", arch="timesformer",
        attention_type="divided_space_time", num_class=CLASSES,
        num_frames=FRAMES, img_size=IMG, optim_type="adamw", clip_grad=1.0,
        seed=SEED, mixup=False, use_fp16=True, drop_path_rate=0.1)


def run_train_steps(tree, batch):
    """TRAIN_STEPS steps of a fresh trainer from ``tree``: per step the
    stats, the kernel launches and the CUDA-event ms."""
    tr = trainer_mod.VideoTransformerTrainer(train_configs(), "cuda",
                                             params=tree)
    steps = []
    for _ in range(TRAIN_STEPS):
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        stats = tr.train_step(batch, TRAIN_LR, TRAIN_WD)
        end.record()
        end.synchronize()
        steps.append({"loss": float(stats["loss"]),
                      "grad_norm": float(stats["grad_norm"]),
                      "launches": read_counts(),
                      "ms": start.elapsed_time(end)})
    return tr, steps


def plain_versions():
    """Every kernel wrapper's launch replaced by its plain version, inside
    the same autograd.Functions."""
    return [mock.patch.object(fused_mhsa, "_launch",
                              fused_mhsa._forward_reference),
            mock.patch.object(fused_mhsa, "_launch_backward",
                              fused_mhsa.fused_prenorm_mhsa_backward_reference),
            mock.patch.object(fused_ffn, "_launch",
                              lambda *a: fused_ffn._forward_reference(*a[:-1])),
            mock.patch.object(fused_ffn, "_launch_backward",
                              fused_ffn.fused_prenorm_ffn_backward_reference)]


def train_slice(rng, card):
    """The training main path: three steps through the kernels (counts
    from 0 per step), the same three from the same state through the plain
    versions, then a profile of one more step."""
    tree = trainer_tree(jax_style_params(rng))
    batch = {"video": rng.standard_normal(
        (TRAIN_CLIPS, FRAMES, 3, IMG, IMG), dtype=np.float32),
        "label": rng.integers(0, CLASSES, TRAIN_CLIPS)}
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}
    tr, steps = run_train_steps(tree, batch)
    launches = {n: sum(st["launches"][n] for st in steps)
                for n in KERNEL_NAMES}
    patches = plain_versions()
    for p in patches:
        p.start()
    try:
        _, plain = run_train_steps(tree, batch)
    finally:
        for p in patches:
            p.stop()
    want = {"fused_prenorm_mhsa": 2 * DEPTH, "fused_prenorm_ffn": DEPTH,
            "fused_prenorm_mhsa_bwd": 2 * DEPTH,
            "fused_prenorm_ffn_bwd": DEPTH}
    for i, (k, p) in enumerate(zip(steps, plain)):
        dl = abs(k["loss"] - p["loss"]) / abs(p["loss"])
        dn = abs(k["grad_norm"] - p["grad_norm"]) / abs(p["grad_norm"])
        log(f"train step {i}: loss {k['loss']:.6f} (plain {p['loss']:.6f}, "
            f"rel {dl:.2e}, tol {LOSS_REL_TOL}), grad_norm "
            f"{k['grad_norm']:.6f} (plain {p['grad_norm']:.6f}, rel "
            f"{dn:.2e}, tol {NORM_REL_TOL}); {k['ms']:.2f} ms (plain "
            f"{p['ms']:.2f} ms); launches {k['launches']}")
        assert np.isfinite([k["loss"], k["grad_norm"], p["loss"],
                            p["grad_norm"]]).all(), (k, p)
        assert dl <= LOSS_REL_TOL and dn <= NORM_REL_TOL, (i, dl, dn)
        assert k["launches"] == want, (i, k["launches"])
        assert not any(p["launches"].values()), p["launches"]
    steady = [st["ms"] for st in steps[1:]]
    ms = sum(steady) / len(steady)
    log(f"train slice: {TRAIN_CLIPS} clips a step, {ms:.2f} ms per step "
        f"(mean of steps 2-{TRAIN_STEPS}; step 1 {steps[0]['ms']:.2f} ms), "
        f"{TRAIN_CLIPS / ms * 1e3:.2f} clips/s on {card}; plain versions "
        f"{sum(p['ms'] for p in plain[1:]) / len(steady):.2f} ms per step; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_forward(lambda: tr.train_step(batch, TRAIN_LR, TRAIN_WD), ms,
                    n=2, what="train step")
    return launches


def seeded_clip(rng):
    frames = rng.integers(0, 256, (FRAMES, 256, 340, 3), dtype=np.uint8)
    return eval_transform_clip(frames, MEAN, STD, IMG)  # (3, T, C, 224, 224)


def serve_requests(predictor, clips):
    server = InferenceServer(predictor, num_frames=FRAMES, img_size=IMG,
                             n_crops=CROPS, max_batch=predictor.max_batch,
                             batch_window_ms=50.0)
    answers = [None] * len(clips)
    start = threading.Barrier(len(clips))

    def client(i):
        start.wait()
        answers[i] = server.submit(clips[i]).result(timeout=300)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(clips))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=360)
        assert not any(t.is_alive() for t in threads), "a request hung"
        return answers, server.stats.snapshot()
    finally:
        server.stop()


def check_server_answers(answers, direct, stats):
    """Each server answer within SERVER_REL_TOL of the direct predictor's
    answer for its own clip, and nearer to it than to any other clip's."""
    scale = np.abs(direct).max(axis=1)
    dist = np.abs(answers[:, None, :] - direct[None, :, :]).max(-1)
    own = np.diag(dist) / scale
    others = np.where(np.eye(len(direct), dtype=bool), np.inf, dist)
    nearest_other = others.min(axis=1) / scale
    hist = {int(k): v for k, v in stats["batch_histogram"].items()}
    log(f"server: {len(answers)} requests answered, batches {hist}, "
        f"p50 {stats['latency_ms']['p50']} ms; answer vs its direct answer: "
        f"worst rel diff {own.max():.3e} (tol {SERVER_REL_TOL}), "
        f"{int((dist.diagonal() == 0).sum())} bit-equal; nearest other "
        f"clip's answer: rel diff >= {nearest_other.min():.3e}")
    assert sum(k * v for k, v in hist.items()) == len(answers), hist
    assert max(hist) > 1, hist
    assert (own <= SERVER_REL_TOL).all(), own
    assert (own < nearest_other).all(), (own, nearest_other)


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:  # one nvcc each
        list(pool.map(_build.build, LIBRARIES))
    for name in LIBRARIES:
        summary = [ln.strip() for ln in _build.build_log(name).splitlines()
                   if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
        log(f"ptxas -v ({name}):\n  " + "\n  ".join(summary))
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    with torch.inference_mode():
        report = kernel_phases(rng) + backward_phases(rng)

        predictor = build_slice(rng)
        clips = np.stack([seeded_clip(rng) for _ in range(CLIPS)])
        batch = torch.from_numpy(clips).to("cuda", torch.bfloat16)
        predict = make_predict_fn(predictor.model, predictor.head, CLASSES,
                                  CROPS)
        requests = [seeded_clip(rng) for _ in range(6)]

        # ---- the serving path: counts from 0, the slice forward, the server
        reset_counts()
        logits = predict(batch)
        torch.cuda.synchronize()
        slice_counts = read_counts()
        predictor.warmup()
        answers, stats = serve_requests(predictor, requests)
        serve_launches = read_counts()
        # ----
        log(f"slice forward launches: {slice_counts}")
        assert slice_counts == {
            "fused_prenorm_mhsa": 2 * DEPTH, "fused_prenorm_ffn": DEPTH,
            "fused_prenorm_mhsa_bwd": 0, "fused_prenorm_ffn_bwd": 0}, \
            slice_counts
        assert serve_launches["fused_prenorm_mhsa"] > 0 and \
            serve_launches["fused_prenorm_ffn"] > 0, serve_launches

        # the same forward through the plain versions, called directly
        with mock.patch.object(
                fused_mhsa, "fused_prenorm_mhsa",
                fused_mhsa.fused_prenorm_mhsa_reference), mock.patch.object(
                fused_ffn, "fused_prenorm_ffn",
                fused_ffn.fused_prenorm_ffn_reference):
            plain = predict(batch)
            plain_ms = timed_ms(lambda: predict(batch), iters=5, warmup=1)
        assert logits.shape == (CLIPS, CLASSES)
        assert torch.isfinite(logits).all()
        err = (logits - plain).abs().max().item()
        scale = plain.abs().max().item()
        log(f"slice logits: max|kernel-plain| = {err:.4e}, max|plain| = "
            f"{scale:.4e}, rel {err / scale:.3e} (tol {SLICE_REL_TOL})")
        assert err <= SLICE_REL_TOL * scale, (err, scale)
        same = (logits.argmax(-1) == plain.argmax(-1)).tolist()
        log(f"slice argmax equal on {sum(same)}/{len(same)} rows")
        assert all(same), same
        ms = timed_ms(lambda: predict(batch), iters=10, warmup=2)
        log(f"slice: batch of {CLIPS} clips x {CROPS} crops, {ms:.2f} ms "
            f"(plain versions {plain_ms:.2f} ms), {CLIPS / ms * 1e3:.1f} "
            f"clips/s on {card}")
        profile_forward(lambda: predict(batch), ms)

        direct = np.stack([predictor(c[None])[0] for c in requests])
    check_server_answers(np.stack(answers), direct, stats)
    del predictor

    # ---- the training path: counts from 0 before each step (train_slice)
    train_launches = train_slice(rng, card)

    src, jax_src = "videotransformer_tpu_torch/csrc/", \
        "videotransformer_tpu/kernels/"
    sources = {
        "fused_prenorm_mhsa": (src + "fused_mhsa.cu",
                               jax_src + "fused_mhsa_pallas.py:125"),
        "fused_prenorm_ffn": (src + "fused_ffn.cu",
                              jax_src + "fused_ffn_pallas.py:65"),
        "fused_prenorm_mhsa_bwd": (src + "fused_mhsa_bwd.cu",
                                   jax_src + "fused_mhsa_pallas.py:288"),
        "fused_prenorm_ffn_bwd": (src + "fused_ffn_bwd.cu",
                                  jax_src + "fused_ffn_pallas.py:168")}
    kernels = []
    for name, (source, replaces) in sources.items():
        phases = [{k: e[k] for k in ("phase", "max_abs_err", "rel_err", "ms",
                                     "plain_ms")}
                  for e in report if e["name"] == name]
        on_path = [e for e in report if e["name"] == name and e["on_path"]]
        by_path = {"serve": serve_launches[name],
                   "train": train_launches[name]}
        assert by_path["train"] > 0, (name, by_path)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_per_forward": slice_counts[name],
            "launches_per_train_step": train_launches[name] // TRAIN_STEPS,
            "max_abs_err": max(e["max_abs_err"] for e in phases),
            "ms": sum(e["ms"] for e in on_path),
            "plain_ms": sum(e["plain_ms"] for e in on_path),
            "phases": phases})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
