"""Smoke run of the PyTorch/CUDA port (videotransformer_tpu_torch) on one
NVIDIA GPU: builds the hand-written kernels from csrc/ (six libraries, one
nvcc each, all started together), holds each against its plain PyTorch
version at the main paths' shapes, and drives the main paths, random
weights from a seed:

- serving: TimeSformer-B/16 (divided space-time, 8x224, 12 layers, 400
  classes) through the predictor and the dynamic-batching server, bf16,
  with a head set from the plain features of the checked clips
  (prototype_head) so that the argmax check holds by a margin;
- training: three supervised AdamW steps of the trainer on TimeSformer-B
  with a batch of 8 clips (fp32 parameters, bf16 compute, DropPath 0.1),
  repeated from the same state with the plain versions patched in;
- ViViT: the same on ViViT-B/16 at 16x224 (tube 2: 8 effective frames),
  8 clips a step, full width and depth, for joint space-time attention
  (12 calls a step over 1569 tokens: B1's and B3's long variant) and for
  the factorised encoder (12 spatial calls over 197 tokens, 4 temporal
  ones over 9), each profiled;
- TimeSformer-B's joint space-time and space-only types at 2 layers: one
  forward each at 8x224 against the plain versions, and one train step of
  joint attention at 16 frames (3137 tokens: the unfused branch, flash
  attention B5/B6) against the same step through the plain versions;
- mim: three MaskFeat pretraining steps on MViT-B (16x224, 16 blocks, two
  q-pool stages, masks from the cube mask generator, HOG targets computed on
  the card from the raw clip) on 8 clips with cuDNN's deterministic
  algorithms, timed, and repeated from the same state through the plain
  versions, compared, and profiled; further steps with cuDNN's default
  algorithms, timed and profiled; then one supervised arch=mvit step (layer decay 0.75,
  decoder_pred frozen) and an eval-mode forward on 2 clips against the plain
  versions;
- data (its own generator, SEED + 4): the device augment of 8 canonical
  uint8 clips (8x256x342) on the card against the CPU on the same draws
  (the supervised recipe, RandAugment with draws covering all 14 ops, the
  mim recipe with its raw pixels, the Center- and ThreeCrop eval recipe),
  each timed; then trainer.fit on TimeSformer-B from uint8 clips: a Loader
  over seeded clips, collate_raw, the pinned prefetch, the augment on the
  card, 4 steps of 8 clips, a val (CenterCrop) and a test (ThreeCrop)
  batch, the first step held against the same step fed the augment's
  output as a video batch, a profile of one step, the host-to-device times
  of the uint8 and the float32 batch; raw-uint8 serving through the
  predictor and the server against the clips-mode predictor; and, where
  this machine has OpenCV, the CLI (model_pretrain.single_run) over the
  bundled demo clips (decided before the phase, and printed either way);
- checkpoint (a generator of its own, SEED + 4): B1 at the 448 serving
  shape (192, 785, 768), its long variant, against its plain version and
  stage by stage beside scaled_dot_product_attention; a synthetic ImageNet
  ViT-B/16 .pth (full geometry, the original repo's naming) imported by the
  trainer (-weights_from imagenet) into TimeSformer-B (divided; two steps)
  and ViViT-B (fact_encoder, Conv3d inflation, 4 temporal layers copied;
  one step), the missing and unexpected names asserted and every imported
  leaf bit-equal to the file's; the TimeSformer's trainer checkpoint
  exported by tools/export_serving.py for 224 and for 448 requests,
  reloaded with load_predictor and served, 8 clips x 3 crops: at 224
  bit-equal to the trainer's weights, at 448 (the 224 table resized on
  every forward) against the plain versions, timed and profiled; the mim
  phase's checkpoint into an arch=mvit supervised trainer (-pretrain_pth),
  bit-equal, one step, and the same weights through a reference .pth
  (save_reference_checkpoint) with no missing or unexpected key;
- parallel (a generator of its own, SEED + 5): B1-B4 at TimeSformer-B's
  tensor-parallel shard shapes, tp = 2 and 4 (Da 384 / 192 over 6 / 3
  heads, hidden 1536 / 768, the row bias zero), against their plain
  versions, rows under "phases"; tools/mp_train_worker.py's run on
  TimeSformer-B (8 clips, the JAX trainer's defaults: three steps, then
  the trainer's fit over one more step and 3 eval clips read by Loaders in
  batches of 2) in this process without a process group and through one
  of world size 1 over NCCL, bit-equal and timed, and the coalesced
  gradient all-reduce timed alone (a step over one data rank skips it);
  then two processes on this card over gloo for TP = 2 and for DP = 2 (4
  clips a rank, the eval shards uneven and padded), each rank's three
  steps within the train phase's bounds of the one-process steps, the
  ranks' lines identical, each rank's launches those of TimeSformer-B
  steps and eval forwards on its shard;
- memory (a generator of its own, SEED + 6): B3's recompute mode (qkv
  rebuilt from x, RECOMPUTE_QKV) at the train shapes (64, 197, 768) and
  (1568, 8, 768), the long (8, 1569, 768) and the CUDA-core (8, 9, 768)
  rows and a tp = 2 shard, against its plain version, its rebuilt qkv and
  gradients bit-equal to B3's from the saved qkv, timed against both;
  TimeSformer-B train steps (8 clips, DropPath 0.1) plain, with -remat,
  with RECOMPUTE_QKV and with both, from the same state, bit-equal, each
  mode's peak device memory, clock, device time and launches (a remat
  step runs every block's forward kernels twice); a ViViT-B joint step
  with and without -remat, bit-equal; get_last_selfattention on
  TimeSformer-B against the plain CPU run.

Each path runs with the launch counts set to 0 just before it and read just
after, and must have gone through its kernels.

    python3 chip_smoke.py

Needs a CUDA card, nvcc (CUDA_HOME, default /usr/local/cuda) and nothing
else outside this checkout. Any failure raises and exits non-zero. The line
before the last is the kernel report: for each kernel its launches in each
main path's run, its worst error, "ms"/"plain_ms"/"library_ms" (CUDA-event
times) beside "bound_ms" (the larger of the bytes it must move over 3.35
TB/s and its FLOPs over 989 TFLOP/s, computed from the shapes), with each
measured phase under "phases". For the TimeSformer kernels the times are
those of their calls in one TimeSformer block; for the flash attention
kernels, of their 16 calls in one mim step, each shape's line also giving
its TFLOP/s, its share of the bound and the host time to issue a call (the
wrapper's and scaled_dot_product_attention's). B1 and B3 are also held and
timed at ViViT-B's joint shape (8, 1569, 768), their long variant, and B5
and B6 at the 16-frame joint shape (96, 3137, 3137), head dim 64: those
rows are under "phases" and outside the totals. The last line is
{"ok": true, "device": {...}}. Its phases took 178-221 s on an H100 (the
six builds included; the data phase 22-28 s) before the checkpoint phase
was added. B3's backward phases also
time its whole call (with the projection products) beside its bound.
Before the serving path it prints B1's, B2's, B3's and B4's stages
(device ms a call) beside torch.matmul at each product's shape (and
scaled_dot_product_attention beside the long attention stage), and B2's
fc1 with and without its GELU epilogue.
"""

import copy
import gc
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

from videotransformer_tpu_torch import model_pretrain
from videotransformer_tpu_torch.data import device_augment, pipeline
from videotransformer_tpu_torch.data.mask_generator import (
    CubeMaskGenerator, pad_cube_marker)
from videotransformer_tpu_torch.data.transforms import eval_transform_clip
from videotransformer_tpu_torch.kernels import (
    _build, flash_attention, fused_ffn, fused_mhsa)
from videotransformer_tpu_torch.models import convert, mvit
from videotransformer_tpu_torch.models.convert import split_artifact_params
from videotransformer_tpu_torch.models.timesformer import (
    TimeSformer, get_vit_base_patch16_224)
from videotransformer_tpu_torch.ops.blocks import ClassificationHead
from videotransformer_tpu_torch.parallel import mesh as pmesh
from videotransformer_tpu_torch.serving.predictor import (
    TorchPredictor, load_predictor, make_predict_fn)
from videotransformer_tpu_torch.serving.server import InferenceServer
from videotransformer_tpu_torch.tools import export_serving, mp_train_worker
from videotransformer_tpu_torch.tools.flash_bench import (
    FLASH_SHAPES, HD as MVIT_HD, JOINT_HD, JOINT_SHAPE, bound, flash_bounds,
    issue_us, sdpa_times, timed_ms)
from videotransformer_tpu_torch.tools.fused_bench import (
    FFN_FWD_PRODUCTS, FFN_PRODUCTS, MHSA_BWD_PRODUCTS, MHSA_PRODUCTS,
    fc1_epilogue_ms, ffn_bwd_bound, ffn_fwd_case, ffn_fwd_products,
    ffn_products, format_stages, matmul_ms, mhsa_bwd_bound, mhsa_bwd_case,
    mhsa_bwd_products, mhsa_products, sdpa_long_ms, stage_times)
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
LIBRARIES = ("fused_mhsa", "fused_ffn", "fused_mhsa_bwd", "fused_ffn_bwd",
             "flash_attention", "flash_attention_bwd")
# MaskFeat on MViT-B at 16x224 (the JAX trainer's objective=mim build);
# FLASH_SHAPES (flash_bench) are the (B·H, Nq, Nkv, calls) of its flash
# attention calls in one batch-8 step, head dim MVIT_HD
MIM_CLIPS, MIM_FRAMES, MIM_STEPS, MIM_LR, MIM_WD = 8, 16, 3, 1e-4, 0.05
# the fused FFN calls of one batch-8 mim step, (rows, D, blocks), hidden 4·D,
# as kernel phases: (phase, shape, LayerNorm eps, on the TimeSformer path,
# calls a step)
MVIT_FFN_PHASES = tuple(
    (f"MViT rows ({rows}, {d}), hidden {4 * d}, eps 1e-6, x{n} a step",
     (rows, d), 1e-6, False, n)
    for rows, d, n in ((50176, 192, 1), (12544, 384, 10), (12544, 768, 2)))
# kernels vs plain versions over the mim steps (bf16 rounding flips through
# 16 blocks and back, compounded by the updates): two H100 runs showed at
# most 2.99e-4 (loss) and 1.29e-4 (grad norm); the bounds leave 3x and 7x.
# The eval forward on 2 clips, after the trainer's nine mim steps (six with
# cuDNN's default algorithms, so it varies between runs): 1.245e-2 to
# 1.660e-2 (features), 6.30e-3 to 8.40e-3 (cls rows) in two runs; the bound
# leaves 1.8x.
MIM_LOSS_REL_TOL = 1e-3
MIM_NORM_REL_TOL = 1e-3
MIM_FEATURE_REL_TOL = 3e-2
# ViViT-B/16 at 16x224 (tube 2: 8 effective frames), 8 clips a step: joint
# space-time attention over 1 + 8·196 = 1569 tokens, B1's and B3's long
# variant; the kernel phases' long rows are at its shape
VIVIT_FRAMES = 16
LONG_SHAPE = (TRAIN_CLIPS, 1 + VIVIT_FRAMES // 2 * (IMG // 16) ** 2, D)
LONG_LABEL = f"long joint space-time {LONG_SHAPE}"
# TimeSformer-B's joint and space-only types at reduced depth: one forward
# each at 8 frames, one train step of joint attention at 16 frames (1 +
# 16·196 = 3137 tokens: the flash attention branch)
TYPES_DEPTH, TYPES_CLIPS = 2, 2


def log(*a):
    print(*a, flush=True)


def bf16_on_card(rng, shape, std, mean=0.0):
    a = rng.standard_normal(shape, dtype=np.float32) * std + mean
    return torch.from_numpy(a).to("cuda", torch.bfloat16)


def in_turns(plain, kernel, iters=20, plain_iters=5):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1 = timed_ms(plain, iters=plain_iters, warmup=1)
    k1, k2 = timed_ms(kernel, iters=iters), timed_ms(kernel, iters=iters)
    p2 = timed_ms(plain, iters=plain_iters, warmup=1)
    return (k1 + k2) / 2, (p1 + p2) / 2


def worst_error(got, want):
    """(max abs error, max over outputs of max|err| / max|want|)."""
    abs_err = rel_err = 0.0
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        e = (a.float() - b).abs().max().item()
        abs_err = max(abs_err, e)
        rel_err = max(rel_err, e / b.abs().max().item())
    return abs_err, rel_err


# ------------------------------------------------------------ kernel phases

def with_variants(counts, call):
    """(``call()``, the attention variants it launched by ``counts``, B1's
    or B3's per-variant launches; "" for a kernel without variants)."""
    before = dict(counts)
    out = call()
    return out, "/".join(v for v, n in counts.items() if n > before[v])


def ffn_weights(rng, d, tp=1):
    """LayerNorm weight and bias, fc1 weight and bias, fc2 weight and bias
    of a width-d FFN (hidden 4·d), bf16 on the card; at ``tp`` > 1 one
    model rank's shard, hidden 4·d / tp and the fc2 bias zero (it is added
    after the all-reduce)."""
    h4 = 4 * d // tp
    w = [bf16_on_card(rng, (d,), 0.1, 1.0), bf16_on_card(rng, (d,), 0.1),
         bf16_on_card(rng, (h4, d), 0.02), bf16_on_card(rng, (h4,), 0.02),
         bf16_on_card(rng, (d, h4), 0.02), bf16_on_card(rng, (d,), 0.02)]
    if tp > 1:
        w[5].zero_()
    return w


def mhsa_weights(rng, d, tp=1):
    """qkv weight and bias, proj weight and bias of a width-d MHSA, bf16 on
    the card; at ``tp`` > 1 one model rank's heads, Da = d / tp, and the
    proj bias zero."""
    da = d // tp
    w = [bf16_on_card(rng, (3 * da, d), 0.02),
         bf16_on_card(rng, (3 * da,), 0.02),
         bf16_on_card(rng, (d, da), 0.02), bf16_on_card(rng, (d,), 0.02)]
    if tp > 1:
        w[3].zero_()
    return w


# (kernel, phase, shape, block_diag, LayerNorm eps, on the TimeSformer path
# once per block, calls a mim step) of the long rows: B1 and B3 at ViViT-B's
# joint space-time shape, drawn from a generator of their own
LONG_FWD_PHASES = [("fused_prenorm_mhsa", LONG_LABEL, LONG_SHAPE, 0, 1e-5,
                    False, 1)]
LONG_BWD_PHASES = [("fused_prenorm_mhsa_bwd", LONG_LABEL, LONG_SHAPE, 0,
                    1e-5, False, 1)]
# the fact_encoder path's temporal stack (its only shape that no other phase
# has): the cls row and the 8 pooled frames of 8 clips, B1's dense variant
# at L <= 64 and B3's CUDA-core kernel, drawn from a generator of their own
FACT_SHAPE = (TRAIN_CLIPS, 1 + VIVIT_FRAMES // 2, D)
FACT_LABEL = f"fact_encoder temporal {FACT_SHAPE}"
FACT_FWD_PHASES = [("fused_prenorm_mhsa", FACT_LABEL, FACT_SHAPE, 0, 1e-5,
                    False, 1)]
FACT_BWD_PHASES = [("fused_prenorm_mhsa_bwd", FACT_LABEL, FACT_SHAPE, 0,
                    1e-5, False, 1)]


def kernel_phases(rng, phases=None, iters=20):
    """Each forward kernel at a main-path shape (``phases``, by default the
    TimeSformer and MViT ones) against its plain version run in fp32 from
    the same bf16 inputs; times in turns (plain, kernel, kernel, plain) from
    CUDA events, ``iters`` calls each. A phase's optional eighth field is
    the tp of a tensor-parallel shard (``mhsa_weights``, ``ffn_weights``)."""
    # (kernel, phase, shape, block_diag, LayerNorm eps, on the TimeSformer
    # path once per block, calls a mim step); the packed layout is the JAX
    # package's
    phases = phases or [
        ("fused_prenorm_mhsa", "dense spatial (192, 197, 768)",
         (192, 197, D), 0, 1e-5, True, 1),
        ("fused_prenorm_mhsa", "block-diagonal temporal (4704, 8, 768)",
         (4704, 8, D), 8, 1e-5, True, 1),
        ("fused_prenorm_mhsa", "block-diagonal packed (42, 896, 768)",
         (42, 896, D), 8, 1e-5, False, 1),
        ("fused_prenorm_ffn", f"rows (37656, {D}), hidden {4 * D}",
         (37656, D), None, 1e-5, True, 1),
    ] + [("fused_prenorm_ffn", label, shape, None, eps, on_path, n)
         for label, shape, eps, on_path, n in MVIT_FFN_PHASES]
    report = []
    for phase in phases:
        name, label, shape, block_diag, eps, on_path, count = phase[:7]
        tp = phase[7] if len(phase) > 7 else 1
        d = shape[-1]
        da, heads = d // tp, HEADS // tp
        x = bf16_on_card(rng, shape, 1.0)
        if block_diag is not None:
            ln = [bf16_on_card(rng, (d,), 0.1, 1.0), bf16_on_card(rng, (d,), 0.1)]
            w = mhsa_weights(rng, d, tp)
            tail = (heads, (da // heads) ** -0.5, eps, False, block_diag)
            kernel = lambda: fused_mhsa.fused_prenorm_mhsa(x, *ln, *w, *tail)
            plain_fn = fused_mhsa.fused_prenorm_mhsa_reference
            counts = fused_mhsa.ATTENTION_LAUNCHES
        else:
            wts = ffn_weights(rng, d, tp)
            ln, w = wts[:2], wts[2:]
            tail = (eps,)
            kernel = lambda: fused_ffn.fused_prenorm_ffn(x, *ln, *w, *tail)
            plain_fn = fused_ffn.fused_prenorm_ffn_reference
            counts = {}
        got, variant = with_variants(counts, kernel)
        torch.cuda.synchronize()
        abs_err, rel_err = worst_error(
            [got], [plain_fn(*[t.float() for t in (x, *ln, *w)], *tail)])
        assert rel_err <= KERNEL_REL_TOL, (label, rel_err)
        # the plain version as the main path would call it: bf16 operands
        ms, plain_ms = in_turns(lambda: plain_fn(x, *ln, *w, *tail), kernel,
                                iters=iters, plain_iters=iters)
        us = issue_us(kernel)
        rows = shape[0] * shape[1] if len(shape) == 3 else shape[0]
        if block_diag is not None:  # qkv, attention over L, proj
            L = block_diag or shape[1]
            flops = 8 * rows * d * da + 4 * rows * L * da
            nbytes = 2 * (2 * rows * d + 4 * d * da + 3 * d + 3 * da)
        else:  # hidden h
            h = 4 * d // tp
            flops = 4 * rows * d * h
            nbytes = 2 * (2 * rows * d + 2 * d * h + 3 * d + h)
        bound_ms, bound_by = bound(flops, nbytes)
        log(f"kernel {name} [{label}]{variant and ' ' + variant}: "
            f"max|kernel-plain|/max|plain| = "
            f"{rel_err:.3e} (tol {KERNEL_REL_TOL}), max abs {abs_err:.3e}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}, {bound_ms / ms:.1%} of it); "
            f"host time to issue a call {us:.1f} us")
        report.append({"name": name, "phase": label, "on_path": on_path,
                       "variant": variant, "count": count,
                       "max_abs_err": abs_err,
                       "rel_err": rel_err, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": None, "bound_ms": bound_ms,
                       "bound_by": bound_by, "issue_us": us})
        del x, w, got
    return report


def backward_phases(rng, phases=None, iters=20):
    """Each backward kernel at a train-step shape (batch of 8 clips) against
    its plain backward run in fp32 from the same bf16 inputs: every output
    gradient within KERNEL_REL_TOL of max|plain| of that gradient, and the
    same bits twice. Times in turns (plain, kernel, kernel, plain): B3 alone
    (``_attn_bwd_launch`` against ``_attn_bwd_reference``: the attention
    backward, d_xn, the LayerNorm backward and the sums, as timed since B3's
    first port) and B3's whole call (``_launch_backward``, with dw_proj, do
    and dw_qkv, against ``fused_prenorm_mhsa_backward_reference``), each
    beside its bound; B4 whole. ``phases`` as in kernel_phases."""
    phases = phases or [
        ("fused_prenorm_mhsa_bwd", "dense spatial (64, 197, 768)",
         (64, 197, D), 0, 1e-5, True, 1),
        ("fused_prenorm_mhsa_bwd", "block-diagonal temporal (1568, 8, 768)",
         (1568, 8, D), 8, 1e-5, True, 1),
        ("fused_prenorm_ffn_bwd", f"rows (12552, {D}), hidden {4 * D}",
         (12552, D), None, 1e-5, True, 1),
    ] + [("fused_prenorm_ffn_bwd", label, shape, None, eps, on_path, n)
         for label, shape, eps, on_path, n in MVIT_FFN_PHASES]
    report = []
    for phase in phases:
        name, label, shape, block_diag, eps, on_path, count = phase[:7]
        tp = phase[7] if len(phase) > 7 else 1
        d = shape[-1]
        da, heads = d // tp, HEADS // tp
        x = bf16_on_card(rng, shape, 1.0)
        g = bf16_on_card(rng, shape, 1.0)
        if block_diag is not None:
            ln = [bf16_on_card(rng, (d,), 0.1, 1.0), bf16_on_card(rng, (d,), 0.1)]
            w = mhsa_weights(rng, d, tp)
            cfg = (heads, (da // heads) ** -0.5, eps, False, block_diag)
            _, qkv, attn, lse = fused_mhsa._launch(x, *ln, *w, *cfg)
            args = (g, x, qkv, attn, lse, ln[0], ln[1], w[0], w[2])
            kernel_all = lambda: fused_mhsa._launch_backward(*args, *cfg)
            plain_all = fused_mhsa.fused_prenorm_mhsa_backward_reference
            plain_args = args[:4] + args[5:]  # the plain one takes no lse
            do = (g.float().reshape(-1, d) @ w[2].float()).to(torch.bfloat16)
            core = (x, qkv, do, None, ln[0], w[0], *cfg[:3], block_diag)
            kernel = lambda: fused_mhsa._attn_bwd_launch(*core, attn=attn,
                                                         lse=lse)
            plain = lambda: fused_mhsa._attn_bwd_reference(*core)
            tail = cfg
            counts = fused_mhsa.ATTENTION_BWD_LAUNCHES
        else:
            w = ffn_weights(rng, d, tp)
            _, h_pre = fused_ffn._launch(x, *w, eps, True)
            args = (g, x, h_pre, w[0], w[1], w[2], w[4])
            tail = (eps,)
            kernel_all = kernel = lambda: fused_ffn._launch_backward(*args,
                                                                   *tail)
            plain_all = fused_ffn.fused_prenorm_ffn_backward_reference
            plain_args = args
            plain = lambda: plain_all(*args, *tail)
            counts = {}
        got, variant = with_variants(counts, kernel_all)
        torch.cuda.synchronize()
        abs_err, rel_err = worst_error(
            got, plain_all(*[a.float() for a in plain_args], *tail))
        assert rel_err <= KERNEL_REL_TOL, (label, rel_err)
        # no atomics: B3's and B4's split sums give the same bits twice
        assert all(torch.equal(a, b) for a, b in zip(got, kernel_all()))
        ms, plain_ms = in_turns(plain, kernel, iters=iters,
                                plain_iters=min(5, iters))
        us = issue_us(kernel_all)
        rows = shape[0] * shape[1] if len(shape) == 3 else shape[0]
        entry = {"name": name, "phase": label, "on_path": on_path,
                 "variant": variant, "count": count, "max_abs_err": abs_err,
                 "rel_err": rel_err,
                 "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                 "issue_us": us}
        if block_diag is not None:
            L = block_diag or shape[1]
            core_got = kernel()
            torch.cuda.synchronize()
            core_err = worst_error(core_got, fused_mhsa._attn_bwd_reference(
                *[a.float() if torch.is_tensor(a) else a for a in core]))
            assert core_err[1] <= KERNEL_REL_TOL, (label, core_err)
            assert all(torch.equal(a, b) for a, b in zip(core_got, kernel()))
            bound_ms, bound_by = mhsa_bwd_bound(rows, L, d, whole=False,
                                                da=da)
            whole_ms, whole_plain = in_turns(
                lambda: plain_all(*plain_args, *tail), kernel_all,
                iters=iters, plain_iters=min(5, iters))
            whole_bound, whole_by = mhsa_bwd_bound(rows, L, d, da=da)
            entry.update(whole_ms=whole_ms, whole_plain_ms=whole_plain,
                         whole_bound_ms=whole_bound, whole_bound_by=whole_by)
            whole = (f"; whole backward call {whole_ms:.4f} ms, plain "
                     f"{whole_plain:.4f} ms, bound {whole_bound:.4f} ms "
                     f"({whole_by}); B3 alone against its plain version "
                     f"{core_err[1]:.3e}")
        else:  # B4: four products, fp32 weight grads
            bound_ms, bound_by = ffn_bwd_bound(rows, d, 4 * d // tp)
            whole = ""
        entry.update(bound_ms=bound_ms, bound_by=bound_by)
        log(f"kernel {name} [{label}]{variant and ' ' + variant}: worst "
            f"max|kernel-plain|/max|plain| "
            f"over the gradients = {rel_err:.3e} (tol {KERNEL_REL_TOL}), "
            f"max abs {abs_err:.3e}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
            f"{bound_ms / ms:.1%} of it); host time to issue the whole call "
            f"{us:.1f} us" + whole)
        report.append(entry)
        del x, g, w, got
    return report


def stage_phases(rng, cases=None):
    """B1 at the serving shapes, B2 at the serving shape and one MViT width,
    B3's whole call at both train shapes and B4 at the TimeSformer train
    shape, stage by stage (device ms a call, torch.profiler), with
    torch.matmul's device ms at each product's GEMM shape beside them (a
    yardstick the port never calls), and B2's fc1 with and without its GELU
    epilogue; tools/fused_bench.py prints the same for every shape and
    against another checkout's kernels. ``cases``: (kernel, phase, shape,
    block_diag or eps) in place of these."""
    cases = cases or [("fused_prenorm_mhsa", "dense spatial (192, 197, 768)",
              (192, 197, D), 0),
             ("fused_prenorm_mhsa", "block-diagonal temporal (4704, 8, 768)",
              (4704, 8, D), 8),
             ("fused_prenorm_mhsa", LONG_LABEL, LONG_SHAPE, 0),
             ("fused_prenorm_ffn", f"rows (37656, {D}), hidden {4 * D}",
              (37656, D), 1e-5),
             ("fused_prenorm_ffn", "MViT rows (12544, 384), hidden 1536",
              (12544, 384), 1e-6),
             ("fused_prenorm_mhsa_bwd", "dense spatial (64, 197, 768)",
              (64, 197, D), 0),
             ("fused_prenorm_mhsa_bwd",
              "block-diagonal temporal (1568, 8, 768)", (1568, 8, D), 8),
             ("fused_prenorm_mhsa_bwd", LONG_LABEL, LONG_SHAPE, 0),
             ("fused_prenorm_ffn_bwd", f"rows (12552, {D}), hidden {4 * D}",
              (12552, D), None)]
    for name, label, shape, extra in cases:
        d = shape[-1]
        rows = shape[0] * shape[1] if len(shape) == 3 else shape[0]
        note = ""
        if name == "fused_prenorm_mhsa":
            w = [bf16_on_card(rng, (d,), 0.1, 1.0), bf16_on_card(rng, (d,), 0.1),
                 bf16_on_card(rng, (3 * d, d), 0.02),
                 bf16_on_card(rng, (3 * d,), 0.02),
                 bf16_on_card(rng, (d, d), 0.02), bf16_on_card(rng, (d,), 0.02)]
            args = (bf16_on_card(rng, shape, 1.0), *w, HEADS,
                    (d // HEADS) ** -0.5, 1e-5, True, extra)
            fn = lambda: fused_mhsa._launch(*args)
            products, pairs = MHSA_PRODUCTS, mhsa_products(args, rows, d)
        elif name == "fused_prenorm_ffn":
            args = ffn_fwd_case(rng, shape)
            fn = lambda: fused_ffn._launch(*args, extra, False)
            products = FFN_FWD_PRODUCTS
            pairs = ffn_fwd_products(args, rows, d)
            with_gelu, without = fc1_epilogue_ms(args, extra)
            note = (f"; fc1 alone with its bias + GELU epilogue "
                    f"{with_gelu:.4f} ms, with the bias alone {without:.4f}")
        elif name == "fused_prenorm_mhsa_bwd":
            args, cfg, _, _ = mhsa_bwd_case(rng, shape, extra)
            fn = lambda: fused_mhsa._launch_backward(*args, *cfg)
            products = MHSA_BWD_PRODUCTS
            pairs = mhsa_bwd_products(args, rows, d)
        else:
            x = bf16_on_card(rng, shape, 1.0)
            w = ffn_weights(rng, d)
            _, h_pre = fused_ffn._launch(x, *w, 1e-5, True)
            args = (bf16_on_card(rng, shape, 1.0), x, h_pre, w[0], w[1],
                    w[2], w[4])
            fn = lambda: fused_ffn._launch_backward(*args, 1e-5)
            products, pairs = FFN_PRODUCTS, ffn_products(args, *shape)
        if name.startswith("fused_prenorm_mhsa") and shape[1] > 256:
            note = long_attention_yardstick(rng, shape, name.endswith("_bwd"))
        yard = matmul_ms(pairs)
        log(f"stages {name} [{label}] (device ms a call): "
            f"{format_stages(stage_times(fn, products))}; torch.matmul at "
            f"the products' GEMM shapes: " + ", ".join(
                f"{p} {t:.4f}" for p, t in zip(products, yard)) + note)
        del args, pairs


def long_attention_yardstick(rng, shape, backward):
    """scaled_dot_product_attention's device ms (forward, or backward) on q,
    k, v of the long stage at x's ``shape`` (B, L, D): (1, B·H, L, D/H), the
    library yardstick beside B1's and B3's long attention stage
    (fused_bench.sdpa_long_ms)."""
    ms = sdpa_long_ms(rng, shape)[int(backward)]
    bh, L = shape[0] * HEADS, shape[1]
    return (f"; scaled_dot_product_attention "
            f"{'backward' if backward else 'forward'} on the attention "
            f"stage's q, k, v (1, {bh}, {L}, {D // HEADS}): {ms:.4f} ms")


def flash_phases(rng, cases=None):
    """B5 and B6 at each (B·H, Nq, Nkv) of a batch-8 mim step, head dim 96,
    and at TimeSformer-B's 16-frame joint attention on 8 clips (96, 3137,
    3137), head dim 64 (not in the mim step's totals; ``cases``): each
    against its plain version run in fp32 from the same bf16 inputs
    (B6 from the kernel's own o and lse, every gradient); times in turns
    (plain, kernel, kernel, plain), and scaled_dot_product_attention's as
    the library's (the backward's: its forward and backward less its
    forward); the host time to issue a call, the wrapper's and the
    library's."""
    report = []
    cases = cases or [(shape, MVIT_HD, "a mim step")
                      for shape in FLASH_SHAPES]
    for (bh, nq, nkv, count), hd, where in cases:
        scale = hd ** -0.5
        label = f"(B·H, Nq, Nkv) = ({bh}, {nq}, {nkv}), hd {hd}, " + (
            f"x{count} {where}" if count else where)
        q = bf16_on_card(rng, (1, bh, nq, hd), 1.0)
        k = bf16_on_card(rng, (1, bh, nkv, hd), 1.0)
        v = bf16_on_card(rng, (1, bh, nkv, hd), 1.0)
        do = bf16_on_card(rng, (1, bh, nq, hd), 1.0)
        fa = flash_attention
        o, lse = fa._launch(q, k, v, scale)
        got_b = fa._launch_backward(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        want_o, _ = fa._forward_reference(q.float(), k.float(), v.float(),
                                          scale)
        fwd_err = worst_error([o], [want_o])
        del want_o
        want_b = fa.flash_attention_backward_reference(
            q.float(), k.float(), v.float(), o.float(), lse, do.float(), scale)
        bwd_err = worst_error(got_b, want_b)
        del want_b, got_b
        for what, (abs_err, rel_err) in (("forward", fwd_err),
                                         ("backward", bwd_err)):
            log(f"kernel flash_attention {what} [{label}]: worst "
                f"max|kernel-plain|/max|plain| = {rel_err:.3e} (tol "
                f"{KERNEL_REL_TOL}), max abs {abs_err:.3e}")
            assert rel_err <= KERNEL_REL_TOL, (what, label, rel_err)
        again = fa._launch_backward(q, k, v, o, lse, do, scale)
        assert all(torch.equal(a, b) for a, b in zip(
            again, fa._launch_backward(q, k, v, o, lse, do, scale)))

        ms, plain_ms = in_turns(lambda: fa._forward_reference(q, k, v, scale),
                                lambda: fa._launch(q, k, v, scale))
        b_ms, b_plain_ms = in_turns(
            lambda: fa.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                          scale),
            lambda: fa._launch_backward(q, k, v, o, lse, do, scale))
        lib_ms, lib_b_ms, *lib_issued = sdpa_times(q, k, v, do, scale)
        issued = (issue_us(lambda: fa._launch(q, k, v, scale)),
                  issue_us(lambda: fa._launch_backward(q, k, v, o, lse, do,
                                                       scale)))
        fwd_bound, bwd_bound, flops = flash_bounds(bh, nq, nkv, hd)
        for name, err, t, t_plain, t_lib, (bms, by), f, us, lib_us in (
                ("flash_attention", fwd_err, ms, plain_ms, lib_ms, fwd_bound,
                 flops, issued[0], lib_issued[0]),
                ("flash_attention_bwd", bwd_err, b_ms, b_plain_ms, lib_b_ms,
                 bwd_bound, 2.5 * flops, issued[1], lib_issued[1])):
            log(f"kernel {name} [{label}]: kernel {t:.4f} ms = "
                f"{f / t / 1e9:.1f} TFLOP/s, {bms / t:.1%} of the bound "
                f"{bms:.4f} ms ({by}); plain {t_plain:.4f} ms, "
                f"scaled_dot_product_attention {t_lib:.4f} ms (device "
                f"times); host time to issue a call: the wrapper {us:.1f} "
                f"us, scaled_dot_product_attention {lib_us:.1f} us")
            report.append({"name": name, "phase": label, "on_path": True,
                           "count": count, "max_abs_err": err[0],
                           "rel_err": err[1], "ms": t, "plain_ms": t_plain,
                           "library_ms": t_lib, "bound_ms": bms,
                           "bound_by": by, "tflops": f / t / 1e9,
                           "issue_us": us, "library_issue_us": lib_us})
        del q, k, v, do, o, lse
    return report


# ---------------------------------------------------------------- profile

def kernel_source(name):
    """Which code a device kernel of the profile comes from, by its name:
    "port" (csrc/: namespace vt), "cuDNN", "cuBLAS", else "other" (PyTorch's
    own kernels, memsets)."""
    name = name.removeprefix("void ")
    low = name.lower()
    if name.startswith("vt::"):
        return "port"
    if "cudnn" in low or "convolve" in low:
        return "cuDNN"
    if any(k in low for k in ("nvjet", "cutlass", "xmma", "cublas", "gemv")):
        return "cuBLAS"
    return "other"


def profile_forward(forward, event_ms, n=3, what="forward", ranges=()):
    """Device kernels of ``n`` calls of ``forward`` under ``torch.profiler``:
    device ms per call for each kernel name, the device's busy share between
    the first kernel's start and the last kernel's end, and the summed
    kernel time over ``event_ms`` (one call by CUDA events, unprofiled);
    the same time split by the code the kernels come from
    (``kernel_source``); then for each ``record_function`` range named in
    ``ranges`` the device time of the kernels launched inside it. Returns
    the summed kernel time per call (None when the trace has none)."""
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
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name not in ranges]
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
    by_source = {}
    for name, (ms, calls) in per_name.items():
        src_ms, src_calls = by_source.get(kernel_source(name), (0.0, 0))
        by_source[kernel_source(name)] = (src_ms + ms, src_calls + calls)
    log(f"  by source (device ms per {what}, calls): " + ", ".join(
        f"{src} {ms:.3f} ({calls // n})" for src, (ms, calls) in sorted(
            by_source.items(), key=lambda kv: -kv[1][0])))
    for name, (ms, calls) in sorted(per_name.items(),
                                    key=lambda kv: -kv[1][0])[:24]:
        log(f"  {ms:9.3f} ms  {calls // n:4d} calls  {name[:110]}")
    for label in ranges:
        spans = [e for e in prof.events() if e.name == label
                 and e.device_type == torch.autograd.DeviceType.CPU]
        log(f"  {sum(e.device_time_total for e in spans) / 1e3 / n:9.3f} ms "
            f" {len(spans) // n:4d} calls  range {label!r} (device time of "
            f"its kernels)")
    return summed


def in_ranges(cls, label):
    """Patches that run the autograd.Function ``cls``'s forward and backward
    each inside a ``record_function`` range: ``label`` and ``label``
    backward."""
    def wrap(fn, name):
        def run(*args):
            with torch.profiler.record_function(name):
                return fn(*args)
        return staticmethod(run)

    return [mock.patch.object(cls, "forward", wrap(cls.forward, label)),
            mock.patch.object(cls, "backward",
                              wrap(cls.backward, f"{label} backward"))]


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
                   (fused_mhsa, "BWD_LAUNCHES"), (fused_ffn, "BWD_LAUNCHES"),
                   (flash_attention, "LAUNCHES"),
                   (flash_attention, "BWD_LAUNCHES"))
KERNEL_NAMES = ("fused_prenorm_mhsa", "fused_prenorm_ffn",
                "fused_prenorm_mhsa_bwd", "fused_prenorm_ffn_bwd",
                "flash_attention", "flash_attention_bwd")


def reset_counts():
    for mod, attr in KERNEL_COUNTERS:
        setattr(mod, attr, 0)
    for counts in (fused_mhsa.ATTENTION_LAUNCHES,
                   fused_mhsa.ATTENTION_BWD_LAUNCHES):
        for variant in counts:
            counts[variant] = 0


# B1's (and in a train step B3's) attention kernels on a TimeSformer
# forward: the dense one for the 12 spatial calls, the packed block-diagonal
# one for the 12 temporal calls, never the CUDA-core one
TIMESFORMER_ATTENTION = {"packed": DEPTH, "dense": DEPTH, "long": 0,
                         "general": 0}


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


def run_train_steps(tree, batch, configs=None, n=TRAIN_STEPS):
    """``n`` steps of a fresh trainer of ``configs`` (train_configs() by
    default) from ``tree``: per step the stats, the kernel launches and the
    CUDA-event ms."""
    tr = trainer_mod.VideoTransformerTrainer(configs or train_configs(),
                                             "cuda", params=tree)
    return tr, take_steps(tr, batch, n)


def take_steps(tr, batch, n):
    """``n`` supervised steps of the trainer ``tr``, the counts from 0 before
    each: per step the stats, the kernel launches, B1's and B3's attention
    variants and the CUDA-event ms."""
    steps = []
    for _ in range(n):
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
                      "attention": dict(fused_mhsa.ATTENTION_LAUNCHES),
                      "attention_bwd": dict(fused_mhsa.ATTENTION_BWD_LAUNCHES),
                      "ms": start.elapsed_time(end)})
    return steps


def plain_versions():
    """Every kernel wrapper's launch replaced by its plain version, inside
    the same autograd.Functions."""
    return [mock.patch.object(fused_mhsa, "_launch",
                              fused_mhsa._forward_reference),
            mock.patch.object(
                fused_mhsa, "_launch_backward",
                lambda g, x, qkv, attn, lse, *rest, **kw:
                fused_mhsa.fused_prenorm_mhsa_backward_reference(
                    g, x, qkv, attn, *rest, **kw)),
            mock.patch.object(fused_ffn, "_launch",
                              lambda *a: fused_ffn._forward_reference(*a[:-1])),
            mock.patch.object(fused_ffn, "_launch_backward",
                              fused_ffn.fused_prenorm_ffn_backward_reference),
            mock.patch.object(flash_attention, "_launch",
                              flash_attention._forward_reference),
            mock.patch.object(
                flash_attention, "_launch_backward",
                flash_attention.flash_attention_backward_reference)]


def check_steps(what, steps, plain, want, attention, attention_bwd):
    """Each step through the kernels against the same step through the
    plain versions (loss within LOSS_REL_TOL, grad norm within
    NORM_REL_TOL), its launches ``want`` and B1's and B3's attention
    variants; the plain steps launched nothing."""
    for i, (k, p) in enumerate(zip(steps, plain)):
        dl = abs(k["loss"] - p["loss"]) / abs(p["loss"])
        dn = abs(k["grad_norm"] - p["grad_norm"]) / abs(p["grad_norm"])
        log(f"{what} step {i}: loss {k['loss']:.6f} (plain {p['loss']:.6f}, "
            f"rel {dl:.2e}, tol {LOSS_REL_TOL}), grad_norm "
            f"{k['grad_norm']:.6f} (plain {p['grad_norm']:.6f}, rel "
            f"{dn:.2e}, tol {NORM_REL_TOL}); {k['ms']:.2f} ms (plain "
            f"{p['ms']:.2f} ms); launches {k['launches']}, attention "
            f"{k['attention']}, backward {k['attention_bwd']}")
        assert np.isfinite([k["loss"], k["grad_norm"], p["loss"],
                            p["grad_norm"]]).all(), (k, p)
        assert dl <= LOSS_REL_TOL and dn <= NORM_REL_TOL, (what, i, dl, dn)
        assert k["launches"] == want, (what, i, k["launches"])
        assert k["attention"] == attention, (what, i, k["attention"])
        assert k["attention_bwd"] == saved_mode(attention_bwd), \
            (what, i, k["attention_bwd"])
        assert not any(p["launches"].values()), p["launches"]


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
    _, plain = with_plain_versions(run_train_steps, tree, batch)
    want = {"fused_prenorm_mhsa": 2 * DEPTH, "fused_prenorm_ffn": DEPTH,
            "fused_prenorm_mhsa_bwd": 2 * DEPTH,
            "fused_prenorm_ffn_bwd": DEPTH, "flash_attention": 0,
            "flash_attention_bwd": 0}
    check_steps("train", steps, plain, want, TIMESFORMER_ATTENTION,
                TIMESFORMER_ATTENTION)
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


# ---------------------------------------------------------------- ViViT

def variants(**counts):
    """B1's or B3's launches by attention variant, the others 0."""
    return {v: counts.get(v, 0) for v in ("packed", "dense", "long",
                                          "general")}


def saved_mode(bwd_variants, recompute=0):
    """B3's expected launch counts: ``bwd_variants`` by attention variant
    and ``recompute`` of them rebuilding qkv (RECOMPUTE_QKV; 0 on every
    path but the memory phase's)."""
    return {**bwd_variants, "recompute": recompute}


# per step: the kernels' launches, B1's and B3's attention variants. Joint:
# 12 calls over 1569 tokens, B1 and B3 long. fact_encoder: 12 spatial
# calls over 197 tokens (dense) and 4 temporal ones over the 9 rows of cls
# and pooled frames (B1 dense; B3 the CUDA-core kernel, as at L = 9)
VIVIT_WANT = {
    "joint_space_time": (
        {"fused_prenorm_mhsa": DEPTH, "fused_prenorm_ffn": DEPTH,
         "fused_prenorm_mhsa_bwd": DEPTH, "fused_prenorm_ffn_bwd": DEPTH,
         "flash_attention": 0, "flash_attention_bwd": 0},
        variants(long=DEPTH), variants(long=DEPTH)),
    "fact_encoder": (
        {"fused_prenorm_mhsa": DEPTH + 4, "fused_prenorm_ffn": DEPTH + 4,
         "fused_prenorm_mhsa_bwd": DEPTH + 4,
         "fused_prenorm_ffn_bwd": DEPTH + 4, "flash_attention": 0,
         "flash_attention_bwd": 0},
        variants(dense=DEPTH + 4), variants(dense=DEPTH, general=4))}


def vivit_configs(kind):
    """The JAX trainer's ViViT-B build for ``-arch vivit -num_frames 16``
    (trainer.py:81-89): supervised, AdamW, per-parameter clip 1.0, fp32
    parameters with bf16 compute, DropPath 0.1."""
    return SimpleNamespace(
        objective="supervised", arch="vivit", attention_type=kind,
        num_class=CLASSES, num_frames=VIVIT_FRAMES, img_size=IMG,
        optim_type="adamw", clip_grad=1.0, seed=SEED, mixup=False,
        use_fp16=True, drop_path_rate=0.1)


def vivit_slice(rng, card, kind):
    """The ViViT-B main path of one attention type: TRAIN_STEPS steps at
    full width (8 clips of 16x224, random weights of the trainer's own
    initialisation from SEED) through the kernels (counts from 0 per step),
    the same steps from the same state through the plain versions,
    compared, then a profile of two more. Returns the launches."""
    torch.cuda.reset_peak_memory_stats()
    cfg = vivit_configs(kind)
    tree = trainer_mod.VideoTransformerTrainer(cfg, "cpu").params_tree()
    batch = {"video": torch.from_numpy(rng.standard_normal(
        (TRAIN_CLIPS, VIVIT_FRAMES, 3, IMG, IMG), dtype=np.float32)).to(
            "cuda"),
        "label": torch.from_numpy(rng.integers(0, CLASSES, TRAIN_CLIPS)).to(
            "cuda")}
    tr, steps = run_train_steps(tree, batch, cfg)
    peak = torch.cuda.max_memory_allocated() / 2**30
    _, plain = with_plain_versions(run_train_steps, tree, batch, cfg)
    check_steps(f"ViViT-B {kind}", steps, plain, *VIVIT_WANT[kind])
    steady = [st["ms"] for st in steps[1:]]
    ms = sum(steady) / len(steady)
    log(f"ViViT-B {kind} slice: {TRAIN_CLIPS} clips of {VIVIT_FRAMES}x{IMG} "
        f"a step, {ms:.2f} ms per step (mean of steps 2-{TRAIN_STEPS}; step "
        f"1 {steps[0]['ms']:.2f} ms), {TRAIN_CLIPS / ms * 1e3:.2f} clips/s "
        f"on {card}; plain versions "
        f"{sum(p['ms'] for p in plain[1:]) / len(steady):.2f} ms per step; "
        f"peak device memory {peak:.2f} GiB (kernel steps)")
    gc.collect()
    profile_forward(lambda: tr.train_step(batch, TRAIN_LR, TRAIN_WD), ms,
                    n=2, what=f"ViViT-B {kind} train step")
    return {n: sum(st["launches"][n] for st in steps) for n in KERNEL_NAMES}


def timesformer_types(rng, card):
    """TimeSformer-B's joint space-time and space-only types at
    TYPES_DEPTH layers: one eval forward of each at 8 frames (TYPES_CLIPS
    clips) through the kernels against the plain versions, and one train
    step of joint attention at 16 frames (1 + 16·196 = 3137 tokens: the
    unfused branch, flash attention B5/B6) through the kernels against the
    same step through the plain versions. Returns the launches."""
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    for kind, want in (("joint_space_time", variants(long=TYPES_DEPTH)),
                       ("space_only", variants(dense=TYPES_DEPTH))):
        model = TimeSformer(num_frames=FRAMES, attention_type=kind,
                            num_transformer_layers=TYPES_DEPTH)
        model.reset_parameters(torch.Generator().manual_seed(SEED))
        model = model.to("cuda", torch.bfloat16).eval()
        clips = bf16_on_card(rng, (TYPES_CLIPS, FRAMES, 3, IMG, IMG), 1.0)
        with torch.inference_mode():
            reset_counts()
            got = model(clips)
            torch.cuda.synchronize()
            counts, attention = read_counts(), dict(
                fused_mhsa.ATTENTION_LAUNCHES)
            plain = with_patches(plain_forward(), model, clips)
        rel = worst_error([got], [plain.float()])[1]
        log(f"TimeSformer-B {kind} forward ({TYPES_DEPTH} layers, "
            f"{TYPES_CLIPS} clips of {FRAMES}x{IMG}): max|kernel-plain|/"
            f"max|plain| = {rel:.3e} (tol {SLICE_REL_TOL}); launches "
            f"{counts}, attention {attention}")
        assert got.shape == (TYPES_CLIPS, D), got.shape
        assert rel <= SLICE_REL_TOL, (kind, rel)
        assert attention == want, (kind, attention)
        assert counts["fused_prenorm_mhsa"] == counts["fused_prenorm_ffn"] \
            == TYPES_DEPTH, counts
        for n in KERNEL_NAMES:
            launches[n] += counts[n]
        del model
    cfg = SimpleNamespace(**{**vars(train_configs()), "num_frames": 16,
                             "attention_type": "joint_space_time"})
    build = lambda c: TimeSformer(num_frames=16, attention_type=c.attention_type,
                                  num_transformer_layers=TYPES_DEPTH)
    with mock.patch.object(trainer_mod, "build_model", build):
        tree = trainer_mod.VideoTransformerTrainer(cfg, "cpu").params_tree()
        batch = {"video": torch.from_numpy(rng.standard_normal(
            (TRAIN_CLIPS, 16, 3, IMG, IMG), dtype=np.float32)).to("cuda"),
            "label": torch.from_numpy(rng.integers(
                0, CLASSES, TRAIN_CLIPS)).to("cuda")}
        _, steps = run_train_steps(tree, batch, cfg, n=1)
        _, plain = with_plain_versions(run_train_steps, tree, batch, cfg, 1)
    want = {"fused_prenorm_mhsa": 0, "fused_prenorm_ffn": TYPES_DEPTH,
            "fused_prenorm_mhsa_bwd": 0, "fused_prenorm_ffn_bwd": TYPES_DEPTH,
            "flash_attention": TYPES_DEPTH,
            "flash_attention_bwd": TYPES_DEPTH}
    check_steps(f"TimeSformer-B joint 16x{IMG} ({TYPES_DEPTH} layers)", steps,
                plain, want, variants(), variants())
    for n in KERNEL_NAMES:
        launches[n] += steps[0]["launches"][n]
    return launches


# ---------------------------------------------------------------- mim

MIM_WANT = {"fused_prenorm_mhsa": 0, "fused_prenorm_ffn": 13,
            "fused_prenorm_mhsa_bwd": 0, "fused_prenorm_ffn_bwd": 13,
            "flash_attention": 16, "flash_attention_bwd": 16}


def mim_configs(objective="mim"):
    """The JAX trainer's MaskFeat build (trainer.py:65-74): MViT-B at
    16x224, AdamW, per-parameter clip 1.0, fp32 parameters with bf16
    compute; layer decay 0.75 for the supervised arch=mvit finetune."""
    return SimpleNamespace(
        objective=objective, arch="mvit", num_class=CLASSES,
        num_frames=MIM_FRAMES, img_size=IMG, optim_type="adamw",
        clip_grad=1.0, seed=SEED, mixup=False, use_fp16=True,
        layer_decay=0.75)


def mim_batch(rng):
    """8 clips: the clip before Normalize (0-255 integers) as ``raw``, its
    normalised copy as ``video``, and cube masks of ratio 0.4 on the 8x14x14
    grid from the cube mask generator under a numpy seed."""
    shape = (MIM_CLIPS, MIM_FRAMES, 3, IMG, IMG)
    raw = rng.integers(0, 256, shape).astype(np.float32)
    mean = np.asarray(MEAN, np.float32)[:, None, None]
    std = np.asarray(STD, np.float32)[:, None, None]
    grid = IMG // 16  # the patch grid after two 2x2 q pools
    gen = CubeMaskGenerator((MIM_FRAMES // 2, grid, grid), mask_ratio=0.4,
                            rng=np.random.default_rng(SEED))
    masks, markers = zip(*[gen() for _ in range(MIM_CLIPS)])
    marker, count = pad_cube_marker(markers, MIM_FRAMES // 2)
    batch = {"video": (raw / 255.0 - mean) / std, "raw": raw,
             "mask": np.stack(masks), "cube_marker": marker,
             "cube_count": count}
    return {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}


def run_mim_steps(tree, batch):
    """MIM_STEPS steps of a fresh mim trainer from ``tree``: per step the
    stats, the kernel launches and the CUDA-event ms."""
    tr = trainer_mod.VideoTransformerTrainer(mim_configs(), "cuda",
                                             params=tree)
    steps = []
    for _ in range(MIM_STEPS):
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        stats = tr.train_step(batch, MIM_LR, MIM_WD)
        end.record()
        end.synchronize()
        steps.append({"loss": float(stats["loss"]),
                      "grad_norm": float(stats["grad_norm"]),
                      "launches": read_counts(),
                      "ms": start.elapsed_time(end)})
    return tr, steps


def with_patches(patches, fn, *args):
    for p in patches:
        p.start()
    try:
        return fn(*args)
    finally:
        for p in patches:
            p.stop()


def with_plain_versions(fn, *args):
    return with_patches(plain_versions(), fn, *args)


def mim_slice(rng, card):
    """The mim main path: three MaskFeat steps through the kernels (counts
    from 0 per step) with cuDNN's deterministic algorithms, timed, and the
    same three from the same state through the plain versions, compared;
    a profile of two more; then further steps of the kernels' trainer with
    cuDNN's default algorithms: one, then two timed, then a profile. Returns
    the launches and the trainer."""
    torch.cuda.reset_peak_memory_stats()
    tree = trainer_mod.VideoTransformerTrainer(mim_configs(), "cpu"
                                               ).params_tree()
    batch = mim_batch(rng)
    # cuDNN's default convolution backward is not reproducible, and AdamW's
    # first updates (about lr·sign(g)) carry that noise to ~1e-3 of the loss
    # by the third step, with or without the kernels: the compared runs take
    # the deterministic algorithms, so each repeats to the bit.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    step = lambda: tr.train_step(batch, MIM_LR, MIM_WD)
    steady = lambda run: sum(st["ms"] for st in run[1:]) / (len(run) - 1)
    try:
        tr, steps = run_mim_steps(tree, batch)
        peak = torch.cuda.max_memory_allocated() / 2**30
        _, plain = with_plain_versions(run_mim_steps, tree, batch)
        # where the timed steps' time went: cuDNN's share against the port's
        profile_forward(step, steady(steps), 2,
                        "mim train step (cuDNN deterministic)")
        gc.collect()  # the profiler's garbage, before the timed steps
    finally:
        torch.backends.cudnn.deterministic = deterministic
    launches = {n: sum(st["launches"][n] for st in steps)
                for n in KERNEL_NAMES}
    for i, (k, p) in enumerate(zip(steps, plain)):
        dl = abs(k["loss"] - p["loss"]) / abs(p["loss"])
        dn = abs(k["grad_norm"] - p["grad_norm"]) / abs(p["grad_norm"])
        log(f"mim step {i}: loss {k['loss']:.6f} (plain {p['loss']:.6f}, "
            f"rel {dl:.2e}, tol {MIM_LOSS_REL_TOL}), grad_norm "
            f"{k['grad_norm']:.6f} (plain {p['grad_norm']:.6f}, rel "
            f"{dn:.2e}, tol {MIM_NORM_REL_TOL}); {k['ms']:.2f} ms (plain "
            f"{p['ms']:.2f} ms); launches {k['launches']}")
        assert np.isfinite([k["loss"], k["grad_norm"], p["loss"],
                            p["grad_norm"]]).all(), (k, p)
        assert k["loss"] > 0 and k["grad_norm"] > 0, k
        assert dl <= MIM_LOSS_REL_TOL and dn <= MIM_NORM_REL_TOL, (i, dl, dn)
        assert k["launches"] == MIM_WANT, (i, k["launches"])
        assert not any(p["launches"].values()), p["launches"]
    det_ms = steady(steps)
    ms = timed_ms(step, iters=2, warmup=1, queued=False)
    log(f"mim slice: {MIM_CLIPS} clips of {MIM_FRAMES}x{IMG} a step on "
        f"{card}; with cuDNN's deterministic algorithms {det_ms:.2f} ms per "
        f"step (mean of steps 2-{MIM_STEPS}; step 1 {steps[0]['ms']:.2f} "
        f"ms), {MIM_CLIPS / det_ms * 1e3:.2f} clips/s, plain versions "
        f"{steady(plain):.2f} ms; with cuDNN's default algorithms {ms:.2f} "
        f"ms per step (two steps after one untimed), "
        f"{MIM_CLIPS / ms * 1e3:.2f} clips/s; peak device memory "
        f"{peak:.2f} GiB (kernel steps)")
    pool = "mvit skip max pool"
    with_patches(in_ranges(mvit._MaxPool3d, pool), profile_forward, step, ms,
                 2, "mim train step", (pool, f"{pool} backward"))
    return launches, tr, batch


def mvit_supervised_step(rng):
    """One supervised arch=mvit step (layer decay 0.75) on the card: its
    launches, and decoder_pred bit-unchanged."""
    tr = trainer_mod.VideoTransformerTrainer(mim_configs("supervised"),
                                             "cuda")
    dec = {n: p.detach().clone()
           for n, p in tr.model.decoder_pred.named_parameters()}
    batch = {"video": torch.from_numpy(rng.standard_normal(
        (MIM_CLIPS, MIM_FRAMES, 3, IMG, IMG), dtype=np.float32)).to("cuda"),
        "label": torch.from_numpy(rng.integers(0, CLASSES, MIM_CLIPS)).to(
            "cuda")}
    reset_counts()
    stats = tr.train_step(batch, MIM_LR, MIM_WD)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"mvit supervised step: loss {float(stats['loss']):.6f}, grad_norm "
        f"{float(stats['grad_norm']):.6f}, launches {launches}")
    assert np.isfinite([float(stats["loss"]), float(stats["grad_norm"])]).all()
    assert launches == MIM_WANT, launches
    for n, p in tr.model.decoder_pred.named_parameters():
        assert torch.equal(p, dec[n]), n
    return launches


def mim_forward_check(tr, batch):
    """One eval-mode forward_features on 2 clips, kernels against the plain
    versions: the worst error relative to max|plain| of the features and of
    their cls rows ([:, 0], the supervised head's input)."""
    video = batch["video"][:2].to(torch.bfloat16)
    tr.model.eval()
    with torch.inference_mode():
        reset_counts()
        got = tr.model.forward_features(video)
        torch.cuda.synchronize()
        counts = read_counts()
        want = with_plain_versions(tr.model.forward_features, video)
    tokens = MIM_FRAMES // 2 * (IMG // 16) ** 2
    assert got.shape == (2, 1 + tokens, tr.model.embed_dims), got.shape
    assert counts == {n: MIM_WANT[n] if "bwd" not in n else 0
                      for n in KERNEL_NAMES}, counts
    rel = worst_error([got], [want.float()])[1]
    rel_cls = worst_error([got[:, 0]], [want[:, 0].float()])[1]
    log(f"mim forward (eval, 2 clips): features max|kernel-plain|/max|plain| "
        f"= {rel:.3e}, cls rows {rel_cls:.3e} (tol {MIM_FEATURE_REL_TOL})")
    assert max(rel, rel_cls) <= MIM_FEATURE_REL_TOL, (rel, rel_cls)


def plain_forward():
    """Patches that send the serving forward through the plain versions,
    called directly (the forward kernels' wrappers replaced)."""
    return [mock.patch.object(fused_mhsa, "fused_prenorm_mhsa",
                              fused_mhsa.fused_prenorm_mhsa_reference),
            mock.patch.object(fused_ffn, "fused_prenorm_ffn",
                              fused_ffn.fused_prenorm_ffn_reference)]


def prototype_head(predictor, batch):
    """Sets the serving check's head by a fixed rule from the plain features
    of its own clips (chosen before any kernel logits are seen, and never
    tuned on them): with F_i clip i's crop-mean feature through the plain
    versions, mu the mean over the clips and u_i = F_i - mu, class i < CLIPS
    has weight u_i / |u_i| and bias -<mu, u_i / |u_i|>, so that row i's plain
    logits are |u_i| for its own class and |u_i| cos(u_i, u_j) for clip j's;
    every other class has weight 0 and bias -max|u_i|, no larger than any
    prototype logit. Each row's top-1 minus top-2 gap, |u_i| (1 - max_j
    cos(u_i, u_j)), is then set by how the clips differ, not by a random
    head. Returns (min |u_i|, max cos between two clips)."""
    b, nc = batch.shape[:2]
    feats = with_patches(plain_forward(), predictor.model,
                         batch.reshape(b * nc, *batch.shape[2:]))
    f = feats.float().reshape(b, nc, -1).mean(1)
    mu = f.mean(0)
    u = f - mu
    norm = u.norm(dim=1)
    proto = u / norm[:, None]
    fc = predictor.head.cls_head
    fc.weight.zero_()
    fc.weight[:b] = proto
    fc.bias.fill_(-norm.max().item())
    fc.bias[:b] = -(proto @ mu)
    cos = proto @ proto.t() - 2 * torch.eye(b, device=proto.device)
    return norm.min().item(), cos.max().item()


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


# ---------------------------------------------------------------- data path

# the uint8 data path: canonical (T, 256, 342, 3) clips, the decoder's
# short-edge-256 output cropped or padded (data/dataset.py), 8 a batch
RAW_HW = (256, 342)
DATA_CLIPS, DATA_STEPS = 8, 4
# the augment on the card against the CPU, on the same draws, in pixel
# units (0-255). The card's elementwise kernels fuse multiply-adds, so a
# crop's source coordinate differs by about an ulp (3e-5 px at 256); on
# random-noise clips, whose neighbours differ by up to 255, that moves the
# bicubic value by up to a few hundredths (measured worst 1.93e-2 px)
AUG_PIXEL_TOL = 5e-2
# RandAugment's discontinuous ops (the nearest warps, Posterize, Solarize,
# Equalize) move a pixel by a whole step where the two devices round a
# source coordinate or a value at a step differently: the share of elements
# apart by more than AUG_PIXEL_TOL, in clips that drew such an op
AUG_STEP_SHARE_TOL = 1e-3
# the first uint8 step against the same step fed the augment's output as a
# video batch: the same kernels on the same inputs
WIRING_REL_TOL = 1e-6
DISCONTINUOUS_OPS = (1, 2, 3, 4, 5, 10, 11, 13)


def data_configs():
    """train_configs() with the fields fit() reads and the device augment;
    DropPath 0, so that the first uint8 step can be taken again from a
    video batch (the augment's draws come first from the same generator)."""
    return SimpleNamespace(**{
        **vars(train_configs()), "drop_path_rate": 0.0, "lr": TRAIN_LR,
        "lr_schedule": "cosine", "warmup_epochs": 1, "min_lr": 1e-6,
        "weight_decay": TRAIN_WD, "weight_decay_end": TRAIN_WD,
        "log_interval": 1, "data_statics": "kinetics",
        "device_augment": True})


def event_ms(fn, iters=5):
    """Mean CUDA-event time of ``fn`` over ``iters`` calls after one, as
    the host issues them."""
    return timed_ms(fn, iters=iters, warmup=1, queued=False)


def kernel_ms(fn, n=2):
    """The device's time for one call of ``fn`` and its kernel count: its
    kernels' durations summed under ``torch.profiler``, over ``n`` calls
    after one. (Timing
    calls queued behind a device-side sleep fails for a call of a few
    hundred launches: the launch queue fills and the host waits.)"""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # with the CPU activity on, the launch calls are CPU events and only the
    # kernels are device events (with CUDA alone they are counted too)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.time_range.end - e.time_range.start for e in kernels)
            / 1e3 / n, len(kernels) // n)


def augment_check(rng, card):
    """Each recipe's augment of 8 canonical uint8 clips on the card against
    the CPU on the same draws (made on the card), and its time per batch."""
    raw = torch.from_numpy(rng.integers(
        0, 256, (DATA_CLIPS, FRAMES) + RAW_HW + (3,), dtype=np.uint8))
    raw_card = raw.to("cuda")
    recipes = {
        "supervised (jitter 0.4)": {},
        "auto_augment": {"auto_augment": True},
        "mim with_raw": {"scale": (0.5, 1.0), "color": (0, 0, 0, 0),
                         "with_raw": True}}
    out = {}
    for name, recipe in recipes.items():
        kw = dict(recipe)
        with_raw = kw.pop("with_raw", False)
        g = torch.Generator(device="cuda").manual_seed(SEED)
        draws = device_augment.draw_augment(g, raw.shape, device="cuda", **kw)
        if kw.get("auto_augment"):  # the 16 draws cover all 14 ops
            draws["ra_ops"] = torch.arange(2 * DATA_CLIPS, device="cuda"
                                           ).view(DATA_CLIPS, 2) % 14
        run = lambda src, d: device_augment.augment_batch(
            src, out_size=IMG, with_raw=with_raw, draws=d, **kw)
        got = run(raw_card, draws)
        want = run(raw, {k: v.cpu() for k, v in draws.items()})
        pairs = list(zip(got, want)) if with_raw else [(got, want)]
        errs = [(a.cpu() - b).abs() * s
                for (a, b), s in zip(pairs, (255 * 0.225, 1.0))]
        err = torch.cat([e.flatten(1) for e in errs], 1)  # per clip
        differ = int((err > 0).sum())
        if kw.get("auto_augment"):
            steps = torch.isin(draws["ra_ops"].cpu(),
                               torch.tensor(DISCONTINUOUS_OPS)).any(1)
            smooth = err[~steps].max().item() if (~steps).any() else 0.0
            share = (err[steps] > AUG_PIXEL_TOL).float().mean().item()
            log(f"augment {name}: card vs CPU on the same draws, clips of "
                f"continuous ops only max {smooth:.3e} px (tol "
                f"{AUG_PIXEL_TOL}); clips with a discontinuous op: "
                f"{share:.3e} of elements apart by more (tol "
                f"{AUG_STEP_SHARE_TOL}), max {err[steps].max().item():.3e} "
                f"px; {differ} of {err.numel()} elements differ at all")
            assert smooth <= AUG_PIXEL_TOL and share <= AUG_STEP_SHARE_TOL
        else:
            log(f"augment {name}: card vs CPU on the same draws, max "
                f"{err.max().item():.3e} px (tol {AUG_PIXEL_TOL}); {differ} "
                f"of {err.numel()} elements differ at all")
            assert err.max().item() <= AUG_PIXEL_TOL, (name, err.max())
        g = torch.Generator(device="cuda").manual_seed(SEED)
        call = lambda: device_augment.augment_batch(
            raw_card, out_size=IMG, with_raw=with_raw, generator=g, **kw)
        device_ms, kernels = kernel_ms(call)
        out[name] = {"ms": event_ms(call), "device_ms": device_ms,
                     "kernels": kernels}
    for three_crop in (False, True):
        name = "eval three-crop" if three_crop else "eval center-crop"
        run = lambda src: device_augment.eval_preprocess_batch(
            src, img_size=IMG, three_crop=three_crop)
        got, want = run(raw_card), run(raw)
        err = ((got.cpu() - want).abs() * 255 * 0.225).max().item()
        log(f"augment {name}: card vs CPU max {err:.3e} px (tol "
            f"{AUG_PIXEL_TOL}), output {tuple(got.shape)}")
        assert err <= AUG_PIXEL_TOL, (name, err)
        device_ms, kernels = kernel_ms(lambda: run(raw_card))
        out[name] = {"ms": event_ms(lambda: run(raw_card)),
                     "device_ms": device_ms, "kernels": kernels}
    log(f"augment per batch of {DATA_CLIPS} clips ({FRAMES}x{RAW_HW[0]}x"
        f"{RAW_HW[1]} uint8 -> {IMG}) on {card}, ms by CUDA events as "
        f"issued (device kernel ms under the profiler; kernels a call): "
        + ", ".join(f"{k} {v['ms']:.3f} ({v['device_ms']:.3f}; "
                    f"{v['kernels']})" for k, v in out.items()))
    return out


class SeededClips:
    """Canonical uint8 clips (T, 256, 342, 3) with labels, made in bulk from
    a numpy generator: what Kinetics(raw_clips=True) returns after the
    decode."""

    def __init__(self, rng, n, pool=16):
        self.clips = rng.integers(0, 256, (pool, FRAMES) + RAW_HW + (3,),
                                  dtype=np.uint8)
        self.labels = rng.integers(0, CLASSES, n)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.clips[i % len(self.clips)], int(self.labels[i])


class SeededData:
    """The data module of the uint8 run: 4 train batches of 8, one val and
    one test batch, through Loader and collate_raw."""

    def __init__(self, rng):
        self.train = SeededClips(rng, DATA_STEPS * DATA_CLIPS)
        self.eval = SeededClips(rng, DATA_CLIPS)

    def _loader(self, data, shuffle):
        return pipeline.Loader(data, DATA_CLIPS, shuffle=shuffle,
                               drop_last=shuffle, num_workers=4,
                               collate_fn=pipeline.collate_raw, seed=SEED,
                               worker_timeout=120.0)

    def train_loader(self):
        return self._loader(self.train, True)

    def val_loader(self):
        return self._loader(self.eval, False)

    def test_loader(self):
        return self._loader(self.eval, False)


def h2d_ms(shape, dtype):
    """CUDA-event ms of one pinned host-to-device copy of ``shape``."""
    host = torch.zeros(shape, dtype=dtype).pin_memory()
    return event_ms(lambda: host.to("cuda", non_blocking=True), iters=10)


def uint8_train(rng, card):
    """trainer.fit over a Loader of uint8 clips (collate_raw, the pinned
    prefetch, the device augment), TimeSformer-B at full width and depth,
    8 clips a step, 4 steps, a val (CenterCrop) and a test (ThreeCrop)
    batch; counts from 0 before fit. Then the first step again from a
    video batch, a profile of one step, and the copies' times."""
    tree = trainer_tree(jax_style_params(rng))
    data = SeededData(rng)
    tr = trainer_mod.VideoTransformerTrainer(
        data_configs(), "cuda", params=tree, do_eval=True, do_test=True)
    steps, first = [], {}
    step = tr.train_step
    last_end = [None]

    def timed_step(batch, lr, wd):
        t0 = time.perf_counter()
        before = read_counts()
        stats = step(batch, lr, wd)
        loss = float(stats["loss"])
        torch.cuda.synchronize()
        end = time.perf_counter()
        first.setdefault("batch", batch)
        steps.append({"ms": (end - t0) * 1e3, "loss": loss,
                      "data_ms": None if last_end[0] is None
                      else (t0 - last_end[0]) * 1e3,
                      "launches": {n: c - before[n]
                                   for n, c in read_counts().items()}})
        last_end[0] = end
        return stats

    gc.collect()
    reset_counts()
    with mock.patch.object(tr, "train_step", timed_step):
        tr.fit(data, max_epochs=1)
    torch.cuda.synchronize()
    launches = read_counts()
    want = {"fused_prenorm_mhsa": 2 * DEPTH, "fused_prenorm_ffn": DEPTH,
            "fused_prenorm_mhsa_bwd": 2 * DEPTH,
            "fused_prenorm_ffn_bwd": DEPTH, "flash_attention": 0,
            "flash_attention_bwd": 0}
    assert len(steps) == DATA_STEPS, len(steps)
    for i, st in enumerate(steps):
        log(f"uint8 train step {i}: loss {st['loss']:.6f}, {st['ms']:.2f} "
            f"ms, data wait {st['data_ms']} ms, launches {st['launches']}")
        assert np.isfinite(st["loss"]) and st["launches"] == want, (i, st)
    assert tr.val_meter.total == tr.test_meter.total == DATA_CLIPS

    # the wiring: the first step again, from the same state and the same
    # draws, with the augment's output fed as a video batch
    ref = trainer_mod.VideoTransformerTrainer(data_configs(), "cuda",
                                              params=tree)
    raw = first["batch"]["raw_video"]
    ref.generator.manual_seed(ref.seed + 7919)  # as train_step seeds step 0
    with torch.no_grad():
        video = ref._augment(raw)
    ref_loss = float(ref.train_step({"video": video,
                                     "label": first["batch"]["label"]},
                                    TRAIN_LR, TRAIN_WD)["loss"])
    rel = abs(steps[0]["loss"] - ref_loss) / abs(ref_loss)
    log(f"uint8 step 0 loss {steps[0]['loss']:.8f} against the same step "
        f"fed the augment's output as a video batch {ref_loss:.8f} (rel "
        f"{rel:.3e}, tol {WIRING_REL_TOL}; bit-equal: "
        f"{steps[0]['loss'] == ref_loss})")
    assert rel <= WIRING_REL_TOL, (steps[0]["loss"], ref_loss)
    del ref, video

    steady = [st["ms"] for st in steps[1:]]
    data_wait = [st["data_ms"] for st in steps[1:]]
    ms = sum(steady) / len(steady)
    u8 = (DATA_CLIPS, FRAMES) + RAW_HW + (3,)
    f32 = (DATA_CLIPS, FRAMES, 3, IMG, IMG)
    u8_ms, f32_ms = h2d_ms(u8, torch.uint8), h2d_ms(f32, torch.float32)
    log(f"uint8 train slice: {DATA_CLIPS} clips a step, steps 2-"
        f"{DATA_STEPS} {', '.join(f'{v:.2f}' for v in steady)} ms on the "
        f"clock (mean {ms:.2f} ms, {DATA_CLIPS / ms * 1e3:.2f} clips/s; step "
        f"1 {steps[0]['ms']:.2f} ms); data wait before steps 2-{DATA_STEPS} "
        f"{', '.join(f'{v:.2f}' for v in data_wait)} ms; host-to-device "
        f"from pinned memory: uint8 batch {np.prod(u8) / 1e6:.1f} MB "
        f"{u8_ms:.3f} ms, float32 batch {4 * np.prod(f32) / 1e6:.1f} MB "
        f"{f32_ms:.3f} ms; on {card} (the float-batch step is the train "
        f"phase's line above)")
    batch = {"raw_video": raw, "label": first["batch"]["label"]}
    profile_forward(lambda: tr.train_step(batch, TRAIN_LR, TRAIN_WD), ms,
                    n=2, what="uint8 train step")
    return launches, {"step_ms": ms, "data_ms": data_wait,
                      "h2d_ms": {"uint8": u8_ms, "float32": f32_ms}}


def raw_serving(rng, predictor, card):
    """A raw-mode predictor on the serving slice's weights, 8 uint8
    requests through the server (counts from 0 before), held against the
    clips-mode predictor fed eval_preprocess_batch's output."""
    manifest = {**predictor.manifest, "input_mode": "raw",
                "input_shape": [FRAMES, *RAW_HW, 3], "input_dtype": "uint8"}
    raw_pred = TorchPredictor(predictor.model, predictor.head, manifest,
                              "cuda", predictor.dtype)
    requests = rng.integers(0, 256, (CLIPS, FRAMES) + RAW_HW + (3,),
                            dtype=np.uint8)
    raw_pred.warmup()
    reset_counts()
    answers, stats = serve_requests(raw_pred, list(requests))
    torch.cuda.synchronize()
    launches = read_counts()
    with torch.inference_mode():
        clips = device_augment.eval_preprocess_batch(
            torch.from_numpy(requests).to("cuda"), img_size=IMG,
            three_crop=True).reshape(CLIPS, CROPS, FRAMES, 3, IMG, IMG)
        want = predictor(clips.cpu().numpy())
    got = np.stack(answers)
    err = np.abs(got - want).max() / np.abs(want).max()
    hist = {int(k): v for k, v in stats["batch_histogram"].items()}
    t0 = time.perf_counter()
    raw_pred(requests)
    ms = (time.perf_counter() - t0) * 1e3
    raw_bytes = int(np.prod(raw_pred.input_shape))
    clip_bytes = 4 * int(np.prod(predictor.input_shape))
    log(f"raw serving: {CLIPS} uint8 requests answered, batches {hist}; "
        f"logits against the clips-mode predictor on eval_preprocess_batch's "
        f"output: rel {err:.3e} (tol {SLICE_REL_TOL}); {ms:.2f} ms per batch "
        f"of {CLIPS} on the host clock (uint8 in, logits out); bytes per "
        f"request raw {raw_bytes} ({raw_bytes / 1e6:.2f} MB), clips "
        f"{clip_bytes} ({clip_bytes / 1e6:.2f} MB) on {card}")
    assert got.shape == (CLIPS, CLASSES) and np.isfinite(got).all()
    assert err <= SLICE_REL_TOL, err
    return launches


def cli_over_demo_clips(card):
    """The port's CLI on the bundled demo clips, where this machine can
    decode mp4 (OpenCV): TimeSformer-B at full width, 1 epoch of batch 4
    with -device_augment True. Decided before the phase starts."""
    if importlib.util.find_spec("cv2") is None:
        log("CLI over the demo clips: did not run; this machine has no "
            "OpenCV (importlib.util.find_spec('cv2') is None), and the port "
            "decodes mp4 only through it")
        return None
    log("CLI over the demo clips: OpenCV found, running single_run")
    demo = "videotransformer_tpu/data/assets/demo"
    with tempfile.TemporaryDirectory() as root:
        trainer = model_pretrain.single_run([
            "-epoch", "1", "-batch_size", "4", "-num_workers", "4",
            "-num_class", "4", "-num_frames", str(FRAMES),
            "-frame_interval", "4", "-objective", "supervised",
            "-arch", "timesformer", "-lr", "0.005", "-warmup_epochs", "1",
            "-root_dir", root, "-train_data_path",
            f"{demo}/demo_train_list.txt", "-classmap_path",
            f"{demo}/demo_classmap.json", "-device", "cuda",
            "-device_augment", "True", "-log_interval", "1"])
    log(f"CLI over the demo clips: {trainer.global_step} steps on {card}")
    assert trainer.global_step == 3, trainer.global_step
    return trainer.global_step


def data_phase(predictor, card):
    """The data path: the augment on the card against the CPU, training
    from uint8 clips, raw-uint8 serving, the CLI over the demo clips. Its
    own generator: the earlier phases' weights and clips stay as they
    were. Returns the launches of the main-path runs (the uint8 fit and
    the raw serving) and the numbers."""
    rng = np.random.default_rng(SEED + 4)
    aug = augment_check(rng, card)
    fit_launches, train = uint8_train(rng, card)
    torch.cuda.empty_cache()
    serve_launches = raw_serving(rng, predictor, card)
    cli_over_demo_clips(card)
    launches = {n: fit_launches[n] + serve_launches[n] for n in KERNEL_NAMES}
    return launches, {"augment_ms": aug, **train}


# ---------------------------------------------------------------- checkpoints

# TimeSformer-B served at 448² from its 224 position table (resized on every
# forward), 8 clips x 3 crops: divided spatial rows of 1 + 28·28 = 785
# tokens (B1's long variant), temporal rows of 8, B2 over 24·(1 + 8·784)
# rows. Its B1 row is a kernel phase of its own, drawn from the checkpoint
# phase's generator
HI_IMG = 448
HI_SHAPE = (CLIPS * CROPS * FRAMES, 1 + (HI_IMG // 16) ** 2, D)
HI_LABEL = f"long divided spatial at {HI_IMG} {HI_SHAPE}"
HI_FWD_PHASES = [("fused_prenorm_mhsa", HI_LABEL, HI_SHAPE, 0, 1e-5, False,
                  1)]
# B1's attention kernels on a TimeSformer forward at 448: the long one for
# the 12 spatial calls, the packed one for the 12 temporal calls
HI_ATTENTION = {"packed": DEPTH, "dense": 0, "long": DEPTH, "general": 0}


def vit_b16_state_dict(rng):
    """A synthetic ImageNet ViT-B/16 checkpoint in the original repo's
    naming, the JAX package's tests/test_checkpoint_surgery.py
    _fake_vit_ckpt at full geometry: 12 layers, 768 wide, 14x14 + 1
    positions, no temporal parts; std 0.02, LayerNorm scales 1 + 0.02·N."""
    def n(*shape, mean=0.0):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32) * 0.02 + mean)

    P = (IMG // 16) ** 2
    sd = {"cls_token": n(1, 1, D), "pos_embed": n(1, P + 1, D),
          "patch_embed.projection.weight": n(D, 3, 16, 16),
          "patch_embed.projection.bias": n(D)}
    for i in range(DEPTH):
        pre = f"transformer_layers.layers.{i}"
        sd.update({f"{pre}.attentions.0.norm.weight": n(D, mean=1.0),
                   f"{pre}.attentions.0.norm.bias": n(D),
                   f"{pre}.attentions.0.attn.qkv.weight": n(3 * D, D),
                   f"{pre}.attentions.0.attn.qkv.bias": n(3 * D),
                   f"{pre}.attentions.0.attn.proj.weight": n(D, D),
                   f"{pre}.attentions.0.attn.proj.bias": n(D),
                   f"{pre}.ffns.0.norm.weight": n(D, mean=1.0),
                   f"{pre}.ffns.0.norm.bias": n(D),
                   f"{pre}.ffns.0.layers.0.0.weight": n(4 * D, D),
                   f"{pre}.ffns.0.layers.0.0.bias": n(4 * D),
                   f"{pre}.ffns.0.layers.1.weight": n(D, 4 * D),
                   f"{pre}.ffns.0.layers.1.bias": n(D)})
    sd.update({"norm.weight": n(D, mean=1.0), "norm.bias": n(D)})
    return sd


def check_import(what, tr, imported, missing, unexpected=()):
    """The trainer's import reported ``missing`` and ``unexpected``, and
    every imported leaf on the card equals ``imported`` (the file's values
    after the surgery's layout transforms) to the bit."""
    got_missing, got_unexpected = tr.pretrained_keys
    own = tr.model.state_dict()
    differ = [k for k, v in imported.items()
              if k in own and not torch.equal(own[k].cpu(),
                                              torch.as_tensor(v))]
    log(f"{what} import: {len(imported)} keys from the file, missing "
        f"{len(got_missing)} {sorted(got_missing)[:3]}..., unexpected "
        f"{got_unexpected}; leaves not bit-equal to the file: {differ}")
    assert sorted(got_missing) == sorted(missing), got_missing
    assert sorted(got_unexpected) == sorted(unexpected), got_unexpected
    assert not differ, differ
    assert all(own[k].device.type == "cuda" for k in own)


def supervised_batch(rng, frames):
    return {"video": torch.from_numpy(rng.standard_normal(
        (TRAIN_CLIPS, frames, 3, IMG, IMG), dtype=np.float32)).to("cuda"),
        "label": torch.from_numpy(rng.integers(0, CLASSES, TRAIN_CLIPS)).to(
            "cuda")}


def check_import_steps(what, steps, want, attention, attention_bwd):
    for i, st in enumerate(steps):
        log(f"{what} step {i}: loss {st['loss']:.6f}, grad_norm "
            f"{st['grad_norm']:.6f}, {st['ms']:.2f} ms; launches "
            f"{st['launches']}, attention {st['attention']}, backward "
            f"{st['attention_bwd']}")
        assert np.isfinite([st["loss"], st["grad_norm"]]).all(), st
        assert st["launches"] == want, (what, i, st["launches"])
        assert st["attention"] == attention, (what, i, st["attention"])
        assert st["attention_bwd"] == saved_mode(attention_bwd), \
            (what, i, st["attention_bwd"])


def export_from_checkpoint(ckpt, out, img_size):
    """tools/export_serving.py over the trainer's checkpoint: TimeSformer-B
    built at 224, the checkpoint loaded strictly, the artifact for
    ``img_size`` requests written to ``out``; the predictor loaded back on
    the card."""
    export_serving.main(["--out", out, "--ckpt", ckpt, "--ckpt_format",
                         "port", "--num_frames", str(FRAMES), "--num_class",
                         str(CLASSES), "--img_size", str(img_size)])
    return load_predictor(out, "cuda")


def served_forward(predictor, clips):
    """One served batch through ``predictor`` (numpy in, numpy out), the
    counts from 0 before it: (logits, launches, B1's attention variants)."""
    reset_counts()
    logits = predictor(clips)
    torch.cuda.synchronize()
    return logits, read_counts(), dict(fused_mhsa.ATTENTION_LAUNCHES)


def serve_at_224(predictor, tr, rng):
    """8 clips x 3 crops through the reloaded predictor, against the
    trainer's model and head cast as the predictor casts them (bf16
    backbone, fp32 head) on the same clips: bit-equal."""
    clips = rng.standard_normal((CLIPS, CROPS, FRAMES, 3, IMG, IMG),
                                dtype=np.float32)
    logits, counts, attention = served_forward(predictor, clips)
    with torch.inference_mode():
        want = make_predict_fn(
            copy.deepcopy(tr.model).to(torch.bfloat16).eval(),
            copy.deepcopy(tr.cls_head).eval(), CLASSES, CROPS)(
                torch.from_numpy(clips).to("cuda", torch.bfloat16))
    want = want.float().cpu().numpy()
    log(f"checkpoint serving at {IMG}: {CLIPS} clips x {CROPS} crops, "
        f"launches {counts}, attention {attention}; logits against the "
        f"trainer's weights: max|diff| {np.abs(logits - want).max():.3e}, "
        f"bit-equal {np.array_equal(logits, want)}")
    assert attention == TIMESFORMER_ATTENTION, attention
    assert counts["fused_prenorm_mhsa"] == 2 * DEPTH and \
        counts["fused_prenorm_ffn"] == DEPTH, counts
    assert logits.shape == (CLIPS, CLASSES) and np.isfinite(logits).all()
    assert np.array_equal(logits, want)
    return counts


def serve_at_448(predictor, rng, card):
    """8 clips x 3 crops at 448² through the predictor exported for 448
    (a 224 model, its table resized on every forward): the head set by
    prototype_head from the plain features, the served logits against the
    same forward through the plain versions (SLICE_REL_TOL, argmax equal by
    a margin >= 1), B1 long 12 and packed 12; then timed and profiled."""
    clips = rng.standard_normal((CLIPS, CROPS, FRAMES, 3, HI_IMG, HI_IMG),
                                dtype=np.float32)
    batch = torch.from_numpy(clips).to("cuda", torch.bfloat16)
    with torch.inference_mode():
        u_min, cos_max = prototype_head(predictor, batch)
    logits, counts, attention = served_forward(predictor, clips)
    predict = make_predict_fn(predictor.model, predictor.head, CLASSES,
                              CROPS)
    with torch.inference_mode():
        plain = with_patches(plain_forward(), predict, batch).float()
        plain = plain.cpu().numpy()
        err = np.abs(logits - plain).max()
        scale = np.abs(plain).max()
        top2 = -np.sort(-plain, axis=1)[:, :2]
        gap = (top2[:, 0] - top2[:, 1]).min()
        margin = gap / (2 * err) if err > 0 else float("inf")
        log(f"checkpoint serving at {HI_IMG}: launches {counts}, attention "
            f"{attention}; head prototypes (smallest |u_i| {u_min:.4e}, "
            f"largest cos {cos_max:.4f}); logits max|kernel-plain| "
            f"{err:.4e}, max|plain| {scale:.4e}, rel {err / scale:.3e} (tol "
            f"{SLICE_REL_TOL}); smallest top-1 minus top-2 gap {gap:.4e} "
            f"(margin x{margin:.2f})")
        assert attention == HI_ATTENTION, attention
        assert counts["fused_prenorm_mhsa"] == 2 * DEPTH and \
            counts["fused_prenorm_ffn"] == DEPTH, counts
        assert logits.shape == (CLIPS, CLASSES) and np.isfinite(logits).all()
        assert err <= SLICE_REL_TOL * scale, (err, scale)
        assert (logits.argmax(1) == plain.argmax(1)).all()
        assert (plain.argmax(1) == np.arange(CLIPS)).all()
        assert margin >= 1, (gap, err)
        plain_ms = with_patches(plain_forward(), timed_ms,
                                lambda: predict(batch), 1, 0, False)
        ms = timed_ms(lambda: predict(batch), iters=5, warmup=1,
                      queued=False)
        log(f"checkpoint serving at {HI_IMG}: batch of {CLIPS} clips x "
            f"{CROPS} crops, {ms:.2f} ms (plain versions {plain_ms:.2f} ms), "
            f"{CLIPS / ms * 1e3:.1f} clips/s on {card}")
        gc.collect()
        profile_forward(lambda: predict(batch), ms, n=2,
                        what=f"{HI_IMG} forward")
    return counts


def maskfeat_handoff(rng, mim_ckpt, tmp):
    """The mim phase's checkpoint into an arch=mvit supervised trainer
    (``-pretrain_pth``: the port's own checkpoint, params only): the
    backbone bit-equal before its step; the same weights through a
    reference .pth (save_reference_checkpoint) into a fresh MaskFeat with
    no missing and no unexpected key; then one step through B2/B4/B5/B6."""
    cfg = SimpleNamespace(**{**vars(mim_configs("supervised")),
                             "pretrain_pth": mim_ckpt})
    tr = trainer_mod.VideoTransformerTrainer(cfg, "cuda")
    saved = torch.load(mim_ckpt, map_location="cpu", weights_only=True)
    check_import("MaskFeat -> arch=mvit", tr, saved["model"], [])
    ref = os.path.join(tmp, "maskfeat.pth")
    convert.save_reference_checkpoint(tr.model, ref)
    fresh = trainer_mod.build_model(cfg)
    missing, unexpected = convert.init_maskfeat_from_kinetics_pretrain(
        fresh, ref, verbose=False)
    own = tr.model.state_dict()
    differ = [k for k, v in fresh.state_dict().items()
              if not torch.equal(v, own[k].cpu())]
    log(f"MaskFeat reference .pth: {len(own)} keys, missing {missing}, "
        f"unexpected {unexpected}, leaves not bit-equal {differ}")
    assert not missing and not unexpected and not differ
    del fresh
    batch = {"video": torch.from_numpy(rng.standard_normal(
        (MIM_CLIPS, MIM_FRAMES, 3, IMG, IMG), dtype=np.float32)).to("cuda"),
        "label": torch.from_numpy(rng.integers(0, CLASSES, MIM_CLIPS)).to(
            "cuda")}
    reset_counts()
    stats = tr.train_step(batch, MIM_LR, MIM_WD)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"arch=mvit step from the MaskFeat checkpoint: loss "
        f"{float(stats['loss']):.6f}, grad_norm "
        f"{float(stats['grad_norm']):.6f}, launches {launches}")
    assert np.isfinite([float(stats["loss"]), float(stats["grad_norm"])]).all()
    assert launches == MIM_WANT, launches
    return launches


def checkpoint_phase(card, mim_ckpt, tmp):
    """Weights in and out of the port, at full width, with its own
    generator (SEED + 4): B1's long row at the 448 serving shape against
    its plain version, and its stages; TimeSformer-B (divided) and ViViT-B
    (fact_encoder) imported from a synthetic ViT-B/16 .pth by the trainer
    (-weights_from imagenet), two and one steps; the TimeSformer's
    checkpoint exported by tools/export_serving.py for 224 and 448
    requests, reloaded, served; the MaskFeat handoff. Returns the launches
    of the main-path runs (steps and served batches) and the kernel
    report's rows."""
    rng = np.random.default_rng(SEED + 4)
    with torch.inference_mode():
        report = kernel_phases(rng, HI_FWD_PHASES)
        assert report[0]["variant"] == "long", report
        stage_phases(rng, [("fused_prenorm_mhsa", HI_LABEL, HI_SHAPE, 0)])
    launches = dict.fromkeys(KERNEL_NAMES, 0)

    def add(counts):
        for n in KERNEL_NAMES:
            launches[n] += counts[n]

    vit = os.path.join(tmp, "vit_b16.pth")
    torch.save(vit_b16_state_dict(rng), vit)
    imported = convert.surgery_from_vit_pretrain(
        convert.load_torch_state_dict(vit), "Conv2d", "divided_space_time",
        "repeat")
    cfg = SimpleNamespace(**{**vars(train_configs()), "pretrain_pth": vit,
                             "weights_from": "imagenet"})
    tr = trainer_mod.VideoTransformerTrainer(cfg, "cuda")
    check_import("TimeSformer-B from ViT-B/16", tr, imported, ["time_embed"] + [
        f"transformer_layers.layers.{i}.attentions.0.temporal_fc.{leaf}"
        for i in range(DEPTH) for leaf in ("weight", "bias")])
    steps = take_steps(tr, supervised_batch(rng, FRAMES), 2)
    check_import_steps("TimeSformer-B from ViT-B/16", steps, {
        "fused_prenorm_mhsa": 2 * DEPTH, "fused_prenorm_ffn": DEPTH,
        "fused_prenorm_mhsa_bwd": 2 * DEPTH, "fused_prenorm_ffn_bwd": DEPTH,
        "flash_attention": 0, "flash_attention_bwd": 0},
        TIMESFORMER_ATTENTION, TIMESFORMER_ATTENTION)
    for st in steps:
        add(st["launches"])
    ckpt = os.path.join(tmp, "timesformer_b.ckpt")
    tr.save_checkpoint(ckpt)

    predictor = export_from_checkpoint(ckpt, os.path.join(tmp, "a224"), IMG)
    add(serve_at_224(predictor, tr, rng))
    del predictor, tr
    torch.cuda.empty_cache()
    predictor = export_from_checkpoint(ckpt, os.path.join(tmp, "a448"),
                                       HI_IMG)
    add(serve_at_448(predictor, rng, card))
    del predictor
    torch.cuda.empty_cache()

    cfg = SimpleNamespace(**{**vars(vivit_configs("fact_encoder")),
                             "pretrain_pth": vit,
                             "weights_from": "imagenet"})
    tr = trainer_mod.VideoTransformerTrainer(cfg, "cuda")
    check_import("ViViT-B fact_encoder from ViT-B/16", tr,
                 convert.surgery_from_vit_pretrain(
                     convert.load_torch_state_dict(vit), "Conv3d",
                     "fact_encoder", "repeat"), ["time_embed"])
    steps = take_steps(tr, supervised_batch(rng, VIVIT_FRAMES), 1)
    check_import_steps("ViViT-B fact_encoder from ViT-B/16", steps,
                       *VIVIT_WANT["fact_encoder"])
    add(steps[0]["launches"])
    del tr
    torch.cuda.empty_cache()

    add(maskfeat_handoff(rng, mim_ckpt, tmp))
    torch.cuda.empty_cache()
    return launches, report


# ---------------------------------------------------------------- parallel

TP_DEGREES = (2, 4)
SHARD_ITERS = 5  # timed calls of each shard-shape row, in each turn
PARALLEL_ARGS = ["--model", "b16", "--device", "cuda", "--clips",
                 str(TRAIN_CLIPS), "--steps", "3", "--drop_path", "0.1",
                 "--eval_clips", "3", "--eval_batch", "2", "--lr",
                 str(TRAIN_LR)]
WORKER_TIMEOUT_S = 300
PARALLEL_STEPS = 4  # the worker's 3 steps and fit's one
# the worker's 3 eval clips in batches of 2: with one data rank 2
# validation and 2 test forwards, over two data ranks 1 and 1 a rank
EVAL_FORWARDS = {1: 4, 2: 2}


def parallel_want(data):
    """A worker's launches at ``data`` data ranks, over its steps and its
    eval forwards: a TimeSformer-B forward is 24 B1 calls (12 packed
    temporal, 12 dense spatial) and 12 B2, a step's backward 24 B3 and 12
    B4, on any shard. (kernel counts, B1's variants, B3's variants)."""
    fwd = PARALLEL_STEPS + EVAL_FORWARDS[data]
    return ({"fused_prenorm_mhsa": fwd * 2 * DEPTH,
             "fused_prenorm_ffn": fwd * DEPTH,
             "fused_prenorm_mhsa_bwd": PARALLEL_STEPS * 2 * DEPTH,
             "fused_prenorm_ffn_bwd": PARALLEL_STEPS * DEPTH,
             "flash_attention": 0, "flash_attention_bwd": 0},
            variants(packed=fwd * DEPTH, dense=fwd * DEPTH),
            variants(packed=PARALLEL_STEPS * DEPTH,
                     dense=PARALLEL_STEPS * DEPTH))


def shard_phases(rng):
    """B1-B4 at TimeSformer-B's tensor-parallel shard shapes, tp = 2 and 4
    (Da = 768 / tp over 12 / tp heads: qkv's 3·Da = 1152 and 576 columns,
    not multiples of B1's 256-column tiles; hidden 3072 / tp; the row
    product's bias zero), at the rows of kernel_phases and backward_phases
    and the long joint rows, against their plain versions; rows under
    "phases", outside the totals."""
    fwd, bwd = [], []
    for tp in TP_DEGREES:
        da, tag = D // tp, f", tp={tp}: Da {D // tp}, {HEADS // tp} heads"
        fwd += [(name, label + tag, shape, bd, 1e-5, False, 1, tp)
                for name, label, shape, bd in (
                    ("fused_prenorm_mhsa", "dense spatial (192, 197, 768)",
                     (192, 197, D), 0),
                    ("fused_prenorm_mhsa",
                     "block-diagonal temporal (4704, 8, 768)",
                     (4704, 8, D), 8),
                    ("fused_prenorm_mhsa", LONG_LABEL, LONG_SHAPE, 0))]
        fwd.append(("fused_prenorm_ffn", f"rows (37656, {D}), hidden "
                    f"{4 * D // tp}, tp={tp}", (37656, D), None, 1e-5, False,
                    1, tp))
        bwd += [(name, label + tag, shape, bd, 1e-5, False, 1, tp)
                for name, label, shape, bd in (
                    ("fused_prenorm_mhsa_bwd", "dense spatial (64, 197, 768)",
                     (64, 197, D), 0),
                    ("fused_prenorm_mhsa_bwd",
                     "block-diagonal temporal (1568, 8, 768)",
                     (1568, 8, D), 8),
                    ("fused_prenorm_mhsa_bwd", LONG_LABEL, LONG_SHAPE, 0))]
        bwd.append(("fused_prenorm_ffn_bwd", f"rows (12552, {D}), hidden "
                    f"{4 * D // tp}, tp={tp}", (12552, D), None, 1e-5, False,
                    1, tp))
    with torch.inference_mode():
        report = kernel_phases(rng, fwd, SHARD_ITERS)
        report += backward_phases(rng, bwd, SHARD_ITERS)
    want = {"dense": ("dense", "dense"), "temporal": ("packed", "packed"),
            "long": ("long", "long")}
    for e in report:
        if e["name"].startswith("fused_prenorm_mhsa"):
            kind = next(k for k in want if k in e["phase"])
            assert e["variant"] == want[kind][0], e
    return report


def parse_worker(out):
    """(steps [(loss, grad_norm, ms, device_ms)], the lines every rank must
    print alike (steps without their times, VAL, TEST, DIGEST), launches)
    of one worker's output."""
    assert "WORKER OK" in out, out[-4000:]
    lines = out.splitlines()
    steps = [tuple(float(v) for v in ln.split()[3::2]) for ln in lines
             if ln.startswith("STEP")]
    same = [ln.split(" ms ")[0] for ln in lines
            if ln.startswith(("STEP", "VAL", "TEST", "DIGEST"))]
    (launch,) = [json.loads(ln[len("LAUNCHES "):]) for ln in lines
                 if ln.startswith("LAUNCHES ")]
    return steps, same, launch


def run_in_process(args, mesh=None):
    """The worker's run here, the counts from 0 before it: (its output as
    one string, its launches, its trainer)."""
    reset_counts()
    lines = []
    tr = mp_train_worker.run(args, "cuda", mesh, out=lines.append)
    torch.cuda.synchronize()
    launch = mp_train_worker.launches()
    return "\n".join(lines + [f"LAUNCHES {json.dumps(launch)}",
                              "WORKER OK"]), launch, tr


def world1_in_turns(trainers, args, n=3):
    """``n`` further steps of each trainer ({"without": the one-process
    trainer, "through": the world-1 process group's}) in turns without,
    through, through, without, on the global batch: {side: [(host ms,
    device ms)]}; then a profile of two steps of each."""
    cfg = mp_train_worker.configs(args)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             mp_train_worker.global_batch(cfg, args.clips,
                                          mp_train_worker.SEED).items()}
    step = lambda tr: mp_train_worker.timed_step(tr, batch, args.lr,
                                                 mp_train_worker.WD)
    gc.collect()
    times = {"without": [], "through": []}
    for side in ("without", "through", "through", "without"):
        for _ in range(n):
            times[side].append(step(trainers[side])[1:])
    for side, tr in trainers.items():
        device_ms = sum(d for _, d in times[side]) / len(times[side])
        profile_forward(lambda: tr.train_step(batch, args.lr,
                                              mp_train_worker.WD),
                        device_ms, n=2,
                        what=f"train step {side} the process group")
    return times


def time_grad_all_reduce(tr, mesh, n=5):
    """(CUDA-event ms, host ms) of one coalesced all-reduce of ``tr``'s
    gradients over ``mesh``'s data group (world 1 here): what a step over
    more than one data rank runs after its backward, and one over a single
    data rank skips."""
    grads = [p.grad for p in tr.optimizer.params.values()
             if p.grad is not None]
    pmesh.all_reduce_coalesced(grads, mesh.data_group)  # warm
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        pmesh.all_reduce_coalesced(grads, mesh.data_group)
    end.record()
    end.synchronize()
    return (start.elapsed_time(end) / n,
            (time.perf_counter() - t0) * 1e3 / n)


def spawn_workers(tmp, what, extra):
    """Two workers of the run ``what`` on this card over gloo."""
    store = f"file://{os.path.join(tmp, what)}"
    return [subprocess.Popen(
        [sys.executable, "-m", "videotransformer_tpu_torch.tools."
         "mp_train_worker", "--rank", str(r), "--world", "2", "--init",
         store, "--backend", "gloo", *PARALLEL_ARGS, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]


def wait_workers(procs):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            assert p.returncode == 0, out[-4000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def parallel_phase(card):
    """Data and tensor parallelism on TimeSformer-B (divided, 8 x 224, 8
    clips, the JAX trainer's defaults), with its own generator (SEED + 5):
    B1-B4 at the tp = 2 and 4 shard shapes (shard_phases);
    tools/mp_train_worker.py's run in this process without a process group
    and through one of world size 1 over NCCL, held bit-equal (losses, grad
    norms, top-k, the parameters' digest), then three more steps of each in
    turns, timed, and two of each profiled, and the data group's coalesced
    gradient all-reduce timed alone (the step skips it at one data rank);
    then two processes on this
    card over gloo for TP = 2 (each rank 6 heads and 1536 hidden units of
    every block) and for DP = 2 (4 clips a rank), each rank's steps held
    against the one-process run within the train phase's bounds, the two
    ranks' lines identical and each rank's launches and attention variants
    those of a TimeSformer-B step. Returns (the launches of the
    process-group runs, this process's and the workers', the kernel rows).
    """
    report = shard_phases(np.random.default_rng(SEED + 5))
    gc.collect()
    torch.cuda.empty_cache()
    args = mp_train_worker.parse_args(PARALLEL_ARGS)
    ref_out, _, ref_tr = run_in_process(args)
    ref_steps, ref_same, _ = parse_worker(ref_out)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pg_") as tmp:
        device = pmesh.init_distributed(
            backend="nccl", init_method=f"file://{tmp}/nccl", rank=0,
            world_size=1, device="cuda")
        try:
            mesh = pmesh.create_mesh(model=1, device=device)
            pg_out, launches, pg_tr = run_in_process(args, mesh)
            turns = world1_in_turns({"without": ref_tr, "through": pg_tr},
                                    args)
            reduce_ms = time_grad_all_reduce(pg_tr, mesh)
        finally:
            torch.distributed.destroy_process_group()
    del ref_tr, pg_tr
    gc.collect()
    torch.cuda.empty_cache()
    pg_steps, pg_same, _ = parse_worker(pg_out)
    assert pg_same == ref_same, (pg_same, ref_same)  # bit-equal
    assert {n: launches[n] for n in KERNEL_NAMES} == parallel_want(1)[0], \
        launches
    mean = lambda side, i: sum(t[i] for t in turns[side]) / len(turns[side])
    log(f"parallel: DP at world 1 over NCCL, {TRAIN_CLIPS} clips a step: "
        f"losses, grad norms, top-k and the parameters' digest bit-equal to "
        f"the run without a process group; in turns (without, through, "
        f"through, without), {len(turns['through'])} steps a side: "
        f"{mean('through', 0):.2f} ms on the clock, {mean('through', 1):.2f} "
        f"ms of CUDA events (without: {mean('without', 0):.2f} / "
        f"{mean('without', 1):.2f} ms): the process group adds "
        f"{mean('through', 0) - mean('without', 0):.2f} ms "
        f"({mean('through', 1) - mean('without', 1):.2f} device; one data "
        f"rank: no gradient all-reduce) on {card}; the coalesced gradient "
        f"all-reduce alone, over NCCL at world 1: {reduce_ms[0]:.3f} ms of "
        f"CUDA events, {reduce_ms[1]:.3f} ms on the clock")
    numbers = {"steps_ms": [s[2] for s in ref_steps],
               "nccl_world1_steps_ms": [s[2] for s in pg_steps],
               "in_turns_without_ms": turns["without"],
               "in_turns_through_ms": turns["through"],
               "nccl_world1_grad_all_reduce_ms": reduce_ms}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gloo_") as tmp:
        runs = {what: spawn_workers(tmp, what, extra)
                for what, extra in (("tp2", ["--tp", "2"]), ("dp2", []))}
        outs = {what: wait_workers(procs) for what, procs in runs.items()}
    for what, (out0, out1) in outs.items():
        (steps, same, launch), (_, same1, launch1) = map(parse_worker,
                                                         (out0, out1))
        want, want_fwd, want_bwd = parallel_want(2 if what == "dp2" else 1)
        assert same == same1, (what, same, same1)  # the two ranks alike
        for i, (k, p) in enumerate(zip(steps, ref_steps)):
            dl = abs(k[0] - p[0]) / abs(p[0])
            dn = abs(k[1] - p[1]) / abs(p[1])
            log(f"parallel {what} step {i}: loss {k[0]:.6f} (one process "
                f"{p[0]:.6f}, rel {dl:.2e}, tol {LOSS_REL_TOL}), grad_norm "
                f"{k[1]:.6f} (one process {p[1]:.6f}, rel {dn:.2e}, tol "
                f"{NORM_REL_TOL}); {k[2]:.1f} ms on the clock, two ranks "
                f"sharing the card over gloo")
            assert np.isfinite(k[:2]).all() and dl <= LOSS_REL_TOL \
                and dn <= NORM_REL_TOL, (what, i, dl, dn)
        for rank, got in enumerate((launch, launch1)):
            log(f"parallel {what} rank {rank} launches: {got}")
            assert {n: got[n] for n in KERNEL_NAMES} == want, \
                (what, rank, got)
            assert got["attention"] == want_fwd, got
            assert got["attention_bwd"] == saved_mode(want_bwd), got
            for n in KERNEL_NAMES:
                launches[n] += got[n]
        numbers[f"{what}_steps_ms"] = [s[2] for s in steps]
    log(f"parallel numbers: {json.dumps(numbers)}")
    return launches, report


# ---------------------------------------------------------------- memory

# B3's recompute mode (qkv rebuilt from x: RECOMPUTE_QKV) at the train
# steps' shapes: (phase, shape, block_diag, tp, the attention variant its
# backward must take)
RECOMPUTE_PHASES = [
    ("dense spatial (64, 197, 768)", (64, 197, D), 0, 1, "dense"),
    ("block-diagonal temporal (1568, 8, 768)", (1568, 8, D), 8, 1,
     "packed"),
    (LONG_LABEL, LONG_SHAPE, 0, 1, "long"),
    (FACT_LABEL, FACT_SHAPE, 0, 1, "general"),
    ("tp = 2 shard, dense spatial (64, 197, 768)", (64, 197, D), 0, 2,
     "dense"),
]
# TimeSformer-B's train step by mode: (mode, remat, RECOMPUTE_QKV)
MEMORY_MODES = (("plain", False, False), ("remat", True, False),
                ("recompute_qkv", False, True),
                ("remat + recompute_qkv", True, True))
MEMORY_STEPS = 2
ATTENTION_WEIGHTS_TOL = 2e-2  # the card's bf16 weights against the CPU's


def recompute_phases(rng, iters=10):
    """B3's whole call in recompute mode against its plain version (qkv
    None: the plain qkv stage) in fp32 from the same bf16 inputs, within
    KERNEL_REL_TOL; the rebuilt qkv (``_recompute_qkv_launch``) bit-equal
    to B1's saved qkv and the seven gradients bit-equal to the call from
    the saved qkv, twice; times in turns against the plain version and
    against the call from the saved qkv, each beside its bound."""
    report = []
    for label, shape, block_diag, tp, want in RECOMPUTE_PHASES:
        d = shape[-1]
        da, heads = d // tp, HEADS // tp
        x = bf16_on_card(rng, shape, 1.0)
        g = bf16_on_card(rng, shape, 1.0)
        ln = [bf16_on_card(rng, (d,), 0.1, 1.0), bf16_on_card(rng, (d,), 0.1)]
        w_qkv, b_qkv, w_proj, b_proj = mhsa_weights(rng, d, tp)
        cfg = (heads, (da // heads) ** -0.5, 1e-5, False, block_diag)
        _, qkv, attn, lse = fused_mhsa._launch(x, *ln, w_qkv, b_qkv, w_proj,
                                               b_proj, *cfg)
        rebuilt = fused_mhsa._recompute_qkv_launch(x, *ln, w_qkv, b_qkv, 1e-5)
        same_qkv = torch.equal(rebuilt, qkv)
        del rebuilt
        rest = (*ln, w_qkv, w_proj)
        saved = lambda: fused_mhsa._launch_backward(g, x, qkv, attn, lse,
                                                    *rest, *cfg)
        kernel = lambda: fused_mhsa._launch_backward(
            g, x, None, attn, lse, *rest, *cfg, b_qkv=b_qkv)
        plain_fn = fused_mhsa.fused_prenorm_mhsa_backward_reference
        plain = lambda: plain_fn(g, x, None, attn, *rest, *cfg, b_qkv=b_qkv)
        got, variant = with_variants(fused_mhsa.ATTENTION_BWD_LAUNCHES, kernel)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, saved())) and \
            all(torch.equal(a, b) for a, b in zip(got, kernel()))
        abs_err, rel_err = worst_error(got, plain_fn(
            g.float(), x.float(), None, attn.float(),
            *[t.float() for t in rest], *cfg, b_qkv=b_qkv.float()))
        log(f"kernel fused_prenorm_mhsa_bwd recompute qkv [{label}] "
            f"{variant}: rebuilt qkv bit-equal to B1's saved qkv: "
            f"{same_qkv}; gradients bit-equal to the call from the saved "
            f"qkv, twice: {same}; max|kernel-plain|/max|plain| = "
            f"{rel_err:.3e} (tol {KERNEL_REL_TOL}), max abs {abs_err:.3e}")
        assert same_qkv and same, label
        assert variant == f"{want}/recompute", (label, variant)
        assert rel_err <= KERNEL_REL_TOL, (label, rel_err)
        ms, plain_ms = in_turns(plain, kernel, iters=iters,
                                plain_iters=min(5, iters))
        ms2, saved_ms = in_turns(saved, kernel, iters=iters,
                                 plain_iters=iters)
        rows, L = shape[0] * shape[1], block_diag or shape[1]
        bound_ms, bound_by = mhsa_bwd_bound(rows, L, d, da=da,
                                            recompute=True)
        saved_bound = mhsa_bwd_bound(rows, L, d, da=da)[0]
        us = issue_us(kernel)
        log(f"  recompute call {ms:.4f} ms (in turns with the saved call: "
            f"{ms2:.4f} against {saved_ms:.4f} ms, +{ms2 - saved_ms:.4f}), "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
            f"{bound_ms / ms:.1%} of it; the saved call's {saved_bound:.4f}, "
            f"+{bound_ms - saved_bound:.4f}); host time to issue {us:.1f} us")
        report.append({"name": "fused_prenorm_mhsa_bwd",
                       "phase": f"recompute qkv, {label}", "on_path": False,
                       "variant": variant, "count": 1,
                       "max_abs_err": abs_err, "rel_err": rel_err, "ms": ms,
                       "plain_ms": plain_ms, "library_ms": None,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "saved_ms": saved_ms, "turns_ms": ms2,
                       "saved_bound_ms": saved_bound, "issue_us": us})
        del x, g, qkv, attn, lse, got
    return report


def params_on_host(tr):
    return [p.detach().cpu() for p in (*tr.model.parameters(),
                                       *tr.cls_head.parameters())]


def memory_mode_steps(tree, batch, configs, remat, recompute, n):
    """``n`` steps of a fresh trainer of ``configs`` with ``remat`` and
    RECOMPUTE_QKV set, from ``tree``: per step the stats, the launches,
    B3's variants, the host clock to a synchronize, the peak device memory
    (``max_memory_allocated`` from a reset just before the step) and the
    parameters after it, on the host; the trainer after them, and the
    device memory the earlier phases left allocated before it was built."""
    cfg = SimpleNamespace(**{**vars(configs), "remat": remat})
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2**30
    with mock.patch.object(fused_mhsa, "RECOMPUTE_QKV", recompute):
        tr = trainer_mod.VideoTransformerTrainer(cfg, "cuda", params=tree)
        steps = []
        for _ in range(n):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            stats = tr.train_step(batch, TRAIN_LR, TRAIN_WD)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            steps.append({"loss": float(stats["loss"]),
                          "grad_norm": float(stats["grad_norm"]),
                          "launches": read_counts(),
                          "attention_bwd": dict(
                              fused_mhsa.ATTENTION_BWD_LAUNCHES),
                          "ms": ms,
                          "peak_gib": torch.cuda.max_memory_allocated()
                          / 2**30, "params": params_on_host(tr)})
    return steps, tr, resident


def compare_modes(what, base, steps, want, want_bwd):
    """Each step of a mode bit-equal to the plain mode's (loss, grad norm,
    every parameter after it), its launches ``want`` and B3's
    ``want_bwd``."""
    for i, (k, p) in enumerate(zip(steps, base)):
        same = k["loss"] == p["loss"] and k["grad_norm"] == p["grad_norm"] \
            and all(torch.equal(a, b) for a, b in zip(k["params"],
                                                       p["params"]))
        log(f"{what} step {i}: loss {k['loss']:.6f} grad_norm "
            f"{k['grad_norm']:.6f}, bit-equal to the plain mode (loss, grad "
            f"norm, every parameter): {same}; {k['ms']:.2f} ms on the clock, "
            f"peak {k['peak_gib']:.3f} GiB; launches {k['launches']}, "
            f"backward {k['attention_bwd']}")
        assert np.isfinite([k["loss"], k["grad_norm"]]).all(), k
        assert same, (what, i)
        assert k["launches"] == want, (what, i, k["launches"])
        assert k["attention_bwd"] == want_bwd, (what, i, k["attention_bwd"])


def memory_phase(card):
    """The memory levers on the main paths' models, a generator of its own
    (SEED + 6): B3's recompute mode against its plain version and against
    B3 (recompute_phases); TimeSformer-B steps (train_configs(): DropPath
    0.1, mixup off; 8 clips) plain, with remat, with RECOMPUTE_QKV and
    with both, MEMORY_STEPS each from the same state, bit-equal, each
    mode's peak memory, clock and (profile of one more step) device time;
    one ViViT-B joint step (16x224, B1/B3 long) with and without remat,
    bit-equal; get_last_selfattention on TimeSformer-B in bf16 on 8 clips
    against the same model's plain CPU run on the first clip. Returns the
    launches of the steps and the forward, B3's calls among them that
    rebuilt qkv, and the report's rows."""
    rng = np.random.default_rng(SEED + 6)
    with torch.inference_mode():
        report = recompute_phases(rng)
    torch.cuda.empty_cache()
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    tree = trainer_tree(jax_style_params(rng))
    batch = {"video": torch.from_numpy(rng.standard_normal(
        (TRAIN_CLIPS, FRAMES, 3, IMG, IMG), dtype=np.float32)).to("cuda"),
        "label": torch.from_numpy(rng.integers(0, CLASSES, TRAIN_CLIPS)).to(
            "cuda")}
    plain_want = {"fused_prenorm_mhsa": 2 * DEPTH, "fused_prenorm_ffn": DEPTH,
                  "fused_prenorm_mhsa_bwd": 2 * DEPTH,
                  "fused_prenorm_ffn_bwd": DEPTH, "flash_attention": 0,
                  "flash_attention_bwd": 0}
    numbers, base, recomputed = {}, None, 0
    for mode, remat, recompute in MEMORY_MODES:
        steps, tr, resident = memory_mode_steps(
            tree, batch, train_configs(), remat, recompute, MEMORY_STEPS)
        if base is None:
            base = steps
        # a remat step runs every block's forward kernels twice
        forwards = 2 if remat else 1
        want = {**plain_want,
                "fused_prenorm_mhsa": forwards * plain_want["fused_prenorm_mhsa"],
                "fused_prenorm_ffn": forwards * plain_want["fused_prenorm_ffn"]}
        compare_modes(f"memory TimeSformer-B {mode}", base, steps, want,
                      saved_mode(TIMESFORMER_ATTENTION,
                                 2 * DEPTH if recompute else 0))
        for st in steps:
            for name in KERNEL_NAMES:
                launches[name] += st["launches"][name]
            recomputed += st["attention_bwd"]["recompute"]
        gc.collect()
        with mock.patch.object(fused_mhsa, "RECOMPUTE_QKV", recompute):
            device_ms = profile_forward(
                lambda: tr.train_step(batch, TRAIN_LR, TRAIN_WD),
                steps[-1]["ms"], n=1, what=f"{mode} train step")
        numbers[mode] = {"peak_gib": max(st["peak_gib"] for st in steps),
                         "resident_gib": resident,
                         "step_ms": [st["ms"] for st in steps],
                         "device_ms": device_ms}
        if mode == "plain":  # the optimizer update's own peak, on the
            # gradients the profiled step left (one more update)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tr.optimizer.step(TRAIN_LR, TRAIN_WD)
            torch.cuda.synchronize()
            numbers["update_peak_gib"] = \
                torch.cuda.max_memory_allocated() / 2**30
        log(f"memory TimeSformer-B {mode}: peak {numbers[mode]['peak_gib']:.3f}"
            f" GiB ({resident:.3f} of it allocated before the trainer), "
            f"steps {numbers[mode]['step_ms']} ms on the clock, "
            f"{device_ms} ms of device kernel time a step, on {card}")
        del tr, steps
    assert numbers["remat"]["peak_gib"] < numbers["plain"]["peak_gib"], \
        numbers
    del base
    # ViViT-B joint, one step with and without remat
    cfg = vivit_configs("joint_space_time")
    tree = trainer_mod.VideoTransformerTrainer(cfg, "cpu").params_tree()
    vbatch = {"video": torch.from_numpy(rng.standard_normal(
        (TRAIN_CLIPS, VIVIT_FRAMES, 3, IMG, IMG), dtype=np.float32)).to(
            "cuda"),
        "label": torch.from_numpy(rng.integers(0, CLASSES, TRAIN_CLIPS)).to(
            "cuda")}
    vbase = None
    for mode, remat in (("plain", False), ("remat", True)):
        steps, tr, resident = memory_mode_steps(tree, vbatch, cfg, remat,
                                                False, 1)
        vbase = vbase or steps
        forwards = 2 if remat else 1
        want = {"fused_prenorm_mhsa": forwards * DEPTH,
                "fused_prenorm_ffn": forwards * DEPTH,
                "fused_prenorm_mhsa_bwd": DEPTH,
                "fused_prenorm_ffn_bwd": DEPTH, "flash_attention": 0,
                "flash_attention_bwd": 0}
        compare_modes(f"memory ViViT-B joint {mode}", vbase, steps, want,
                      saved_mode(variants(long=DEPTH)))
        numbers[f"vivit joint {mode}"] = {"peak_gib": steps[0]["peak_gib"],
                                          "resident_gib": resident,
                                          "step_ms": [steps[0]["ms"]]}
        for name in KERNEL_NAMES:
            launches[name] += steps[0]["launches"][name]
        del tr, steps
    del vbase, tree
    gc.collect()
    torch.cuda.empty_cache()
    # the attention-weights path: the last block's spatial attention plain,
    # every block before it and the last block's temporal one on B1/B2
    model_sd, _ = split_artifact_params(jax_style_params(rng))
    model = get_vit_base_patch16_224(num_frames=FRAMES)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in model_sd.items()}, strict=True)
    model = model.to(torch.bfloat16)
    card_model = copy.deepcopy(model).to("cuda")
    clips = bf16_on_card(rng, (CLIPS, FRAMES, 3, IMG, IMG), 1.0)
    with torch.inference_mode():
        reset_counts()
        weights = card_model.get_last_selfattention(clips)
        torch.cuda.synchronize()
        counts = read_counts()
        cpu = model.float().get_last_selfattention(clips[:1].cpu().float())
    rows = weights.sum(-1)
    err = (weights[:FRAMES].cpu() - cpu).abs().max().item()
    log(f"get_last_selfattention on TimeSformer-B ({CLIPS} clips, bf16): "
        f"shape {tuple(weights.shape)}, rows summing to 1 within "
        f"{(rows - 1).abs().max().item():.3e}; the first clip's within "
        f"{err:.3e} of the plain fp32 CPU run (tol {ATTENTION_WEIGHTS_TOL}); "
        f"launches {counts}")
    assert weights.shape == (CLIPS * FRAMES, HEADS, 1 + (IMG // 16) ** 2,
                             1 + (IMG // 16) ** 2), weights.shape
    assert torch.isfinite(weights).all()
    assert (rows - 1).abs().max().item() <= 1e-3
    assert err <= ATTENTION_WEIGHTS_TOL, err
    assert counts == {"fused_prenorm_mhsa": 2 * DEPTH - 1,
                      "fused_prenorm_ffn": DEPTH - 1,
                      "fused_prenorm_mhsa_bwd": 0, "fused_prenorm_ffn_bwd": 0,
                      "flash_attention": 0, "flash_attention_bwd": 0}, counts
    for name in KERNEL_NAMES:
        launches[name] += counts[name]
    log(f"memory numbers: {json.dumps(numbers)}")
    return launches, recomputed, report


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
    seconds = {"build": time.perf_counter() - t0}
    log(f"kernels built in {seconds['build']:.1f} s")

    def lap(name, since):
        seconds[name] = time.perf_counter() - since
        log(f"phase {name}: {seconds[name]:.1f} s")
        return time.perf_counter()

    rng = np.random.default_rng(SEED)
    # the phases added with ViViT draw from a generator of their own: the
    # earlier paths' weights and clips stay those of the runs before them
    long_rng = np.random.default_rng(SEED + 2)
    t0 = time.perf_counter()
    report = flash_phases(rng)  # autograd on (the library's backward)
    report += flash_phases(long_rng, [(JOINT_SHAPE, JOINT_HD,
                                       "TimeSformer-B joint at 16 frames")])
    with torch.inference_mode():
        report += kernel_phases(rng) + backward_phases(rng)
        report += kernel_phases(long_rng, LONG_FWD_PHASES)
        report += backward_phases(long_rng, LONG_BWD_PHASES)
        fact_rng = np.random.default_rng(SEED + 3)
        report += kernel_phases(fact_rng, FACT_FWD_PHASES)
        report += backward_phases(fact_rng, FACT_BWD_PHASES)
        ran = {(e["name"], e["phase"]): e.get("variant") for e in report}
        assert ran[("fused_prenorm_mhsa", LONG_LABEL)] == "long", ran
        assert ran[("fused_prenorm_mhsa_bwd", LONG_LABEL)] == "long", ran
        assert ran[("fused_prenorm_mhsa", FACT_LABEL)] == "dense", ran
        assert ran[("fused_prenorm_mhsa_bwd", FACT_LABEL)] == "general", ran
        # its own generator: the main paths' weights and clips stay those
        # of the runs before the stage lines were added
        stage_phases(np.random.default_rng(SEED + 1))
    # the profiler sessions leave garbage in reference cycles: collect it
    # here rather than inside a timed step
    gc.collect()
    t0 = lap("kernel phases", t0)
    with torch.inference_mode():
        predictor = build_slice(rng)
        clips = np.stack([seeded_clip(rng) for _ in range(CLIPS)])
        batch = torch.from_numpy(clips).to("cuda", torch.bfloat16)
        predict = make_predict_fn(predictor.model, predictor.head, CLASSES,
                                  CROPS)
        requests = [seeded_clip(rng) for _ in range(6)]
        u_min, cos_max = prototype_head(predictor, batch)
        log(f"serving head: prototypes of the {CLIPS} clips' plain features "
            f"(smallest |u_i| {u_min:.4e}, largest cos between two clips "
            f"{cos_max:.4f})")

        # ---- the serving path: counts from 0, the slice forward, the server
        reset_counts()
        logits = predict(batch)
        torch.cuda.synchronize()
        slice_counts = read_counts()
        slice_attention = dict(fused_mhsa.ATTENTION_LAUNCHES)
        predictor.warmup()
        answers, stats = serve_requests(predictor, requests)
        serve_launches = read_counts()
        # ----
        log(f"slice forward launches: {slice_counts}; B1's attention "
            f"kernels: {slice_attention}")
        assert slice_attention == TIMESFORMER_ATTENTION, slice_attention
        assert slice_counts == {
            "fused_prenorm_mhsa": 2 * DEPTH, "fused_prenorm_ffn": DEPTH,
            "fused_prenorm_mhsa_bwd": 0, "fused_prenorm_ffn_bwd": 0,
            "flash_attention": 0, "flash_attention_bwd": 0}, slice_counts
        assert serve_launches["fused_prenorm_mhsa"] > 0 and \
            serve_launches["fused_prenorm_ffn"] > 0, serve_launches

        # the same forward through the plain versions, called directly
        plain, plain_ms = with_patches(plain_forward(), lambda: (
            predict(batch), timed_ms(lambda: predict(batch), iters=5,
                                     warmup=1, queued=False)))
        assert logits.shape == (CLIPS, CLASSES)
        assert torch.isfinite(logits).all()
        err = (logits - plain).abs().max().item()
        scale = plain.abs().max().item()
        log(f"slice logits: max|kernel-plain| = {err:.4e}, max|plain| = "
            f"{scale:.4e}, rel {err / scale:.3e} (tol {SLICE_REL_TOL})")
        assert err <= SLICE_REL_TOL * scale, (err, scale)
        same = (logits.argmax(-1) == plain.argmax(-1)).tolist()
        # a row's argmax can differ only where the plain top-1 minus top-2
        # gap is below 2 max|kernel-plain|: the check holds by margin when
        # every gap is above it (the prototype head, prototype_head)
        top2 = plain.float().topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).min().item()
        margin = gap / (2 * err) if err > 0 else float("inf")
        log(f"slice argmax equal on {sum(same)}/{len(same)} rows; smallest "
            f"top-1 minus top-2 gap of the plain logits {gap:.4e} against "
            f"2 max|kernel-plain| = {2 * err:.4e} (margin x{margin:.2f})")
        assert all(same), same
        assert (plain.argmax(-1).cpu() == torch.arange(CLIPS)).all()
        assert margin >= 1, (gap, err)
        ms = timed_ms(lambda: predict(batch), iters=10, warmup=2,
                      queued=False)
        log(f"slice: batch of {CLIPS} clips x {CROPS} crops, {ms:.2f} ms "
            f"(plain versions {plain_ms:.2f} ms), {CLIPS / ms * 1e3:.1f} "
            f"clips/s on {card}")
        profile_forward(lambda: predict(batch), ms)

        direct = np.stack([predictor(c[None])[0] for c in requests])
    check_server_answers(np.stack(answers), direct, stats)
    t0 = lap("serve", t0)

    # ---- the training path: counts from 0 before each step (train_slice)
    train_launches = train_slice(rng, card)
    t0 = lap("train", t0)
    torch.cuda.empty_cache()

    # ---- ViViT-B, joint space-time and fact_encoder: counts from 0 before
    # each step (vivit_slice)
    vivit_launches = dict.fromkeys(KERNEL_NAMES, 0)
    for kind in ("joint_space_time", "fact_encoder"):
        for n, c in vivit_slice(long_rng, card, kind).items():
            vivit_launches[n] += c
        t0 = lap(f"vivit {kind}", t0)
        torch.cuda.empty_cache()

    # ---- TimeSformer-B's joint and space-only types: counts from 0 before
    # each forward and the step (timesformer_types)
    types_launches = timesformer_types(long_rng, card)
    t0 = lap("timesformer joint and space_only", t0)
    torch.cuda.empty_cache()

    # ---- the mim path: counts from 0 before each step (mim_slice), then
    # the supervised MViT step (counts from 0 before it)
    mim_launches, mim_trainer, mim_data = mim_slice(rng, card)
    t0 = lap("mim", t0)
    mim_forward_check(mim_trainer, mim_data)
    # the checkpoint phase's MaskFeat handoff starts from this checkpoint
    scratch = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    mim_ckpt = os.path.join(scratch.name, "mim_last_checkpoint")
    mim_trainer.save_checkpoint(mim_ckpt)
    del mim_trainer, mim_data
    torch.cuda.empty_cache()
    mvit_launches = mvit_supervised_step(rng)
    t0 = lap("mvit supervised step and mim forward check", t0)
    torch.cuda.empty_cache()

    # ---- the data path: counts from 0 before the uint8 fit and before the
    # raw serving run (data_phase)
    data_launches, data_numbers = data_phase(predictor, card)
    del predictor
    t0 = lap("data", t0)
    torch.cuda.empty_cache()

    # ---- weights in and out: counts from 0 before each step and each
    # served batch (checkpoint_phase)
    try:
        ckpt_launches, ckpt_report = checkpoint_phase(card, mim_ckpt,
                                                      scratch.name)
    finally:
        scratch.cleanup()
    report += ckpt_report
    t0 = lap("checkpoint", t0)

    # ---- data and tensor parallelism: counts from 0 before the
    # process-group run here; each worker's from its start (parallel_phase)
    par_launches, par_report = parallel_phase(card)
    report += par_report
    t0 = lap("parallel", t0)
    torch.cuda.empty_cache()

    # ---- the memory levers: counts from 0 before each step and before the
    # attention-weights forward (memory_phase)
    mem_launches, mem_recomputed, mem_report = memory_phase(card)
    report += mem_report
    t0 = lap("memory", t0)

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
                                  jax_src + "fused_ffn_pallas.py:168"),
        "flash_attention": (src + "flash_attention.cu",
                            jax_src + "flash_attention_pallas.py:52"),
        "flash_attention_bwd": (src + "flash_attention_bwd.cu",
                                jax_src + "flash_attention_pallas.py:97")}
    kernels = []
    for name, (source, replaces) in sources.items():
        phases = [{k: v for k, v in e.items() if k not in (
                       "name", "on_path", "tflops", "library_issue_us")}
                  for e in report if e["name"] == name]
        # the on-path phases, each weighted by its calls: one TimeSformer
        # block, or one mim step for the flash attention kernels
        on_path = [e for e in report if e["name"] == name and e["on_path"]]
        total = lambda key: sum(e["count"] * e[key] for e in on_path)
        library = [e["library_ms"] for e in on_path]
        by_path = {"serve": serve_launches[name],
                   "train": train_launches[name], "mim": mim_launches[name],
                   "mvit": mvit_launches[name],
                   "vivit": vivit_launches[name],
                   "timesformer_types": types_launches[name],
                   "data": data_launches[name],
                   "checkpoint": ckpt_launches[name],
                   "parallel": par_launches[name],
                   "memory": mem_launches[name]}
        assert sum(by_path.values()) > 0, (name, by_path)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_per_forward": slice_counts[name],
            "launches_per_train_step": train_launches[name] // TRAIN_STEPS,
            "launches_per_mim_step": mim_launches[name] // MIM_STEPS,
            "max_abs_err": max(e["max_abs_err"] for e in phases),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "library_ms": None if None in library else total("library_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": max(on_path, key=lambda e: e["count"] * e["bound_ms"]
                            )["bound_by"],
            "phases": phases})
        if name == "fused_prenorm_mhsa_bwd":  # B3r: of the memory path's
            kernels[-1]["launches_rebuilding_qkv"] = mem_recomputed
    log(f"data path numbers: {json.dumps(data_numbers)}")
    log(f"phase seconds: {json.dumps(seconds)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
