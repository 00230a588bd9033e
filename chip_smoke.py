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
  joint attention at 16 frames (3137 tokens: the fused call, B1's and B3's
  long variant) against the same step through the plain versions;
- MViT's pools (a generator of their own, SEED + 11): the pool kernels
  (kernels/mvit_pool.py) at each of the 16 blocks of a MaskFeat step at 32
  clips (34 pools) against their plain version in fp32, forward and
  backward, each twice to the bit, timed beside the plain version in bf16
  and cuDNN's conv3d alone on dense operands, with each block's bound;
- mim: three MaskFeat pretraining steps on MViT-B (16x224, 16 blocks, two
  q-pool stages, masks from the cube mask generator, HOG targets computed on
  the card from the raw clip) on 8 clips with cuDNN's deterministic
  algorithms, timed, and repeated from the same state through the plain
  versions, compared, and profiled; further steps with cuDNN's default
  algorithms, timed and profiled, a traced step in which cuDNN runs the
  patch embed's convolution alone (no pool), and two steps from one state
  twice, bit-equal, with the default algorithms; then one supervised
  arch=mvit step (layer decay 0.75, decoder_pred frozen) and an eval-mode
  forward on 2 clips against the plain versions;
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
  predictor and the server against the clips-mode predictor; the decode
  line (decided before its phase, printed either way: the backend that
  video_reader's backend="auto" picked, the native decoder's build error
  if it picked OpenCV, whether FFmpeg's headers are on this machine);
  where the native decoder builds, it against OpenCV on every demo clip at
  the JAX package's bounds, and each backend's ms per clip for the
  dataset's raw read (8 frames at short edge 256, host clock, median of 5
  passes after 1); the loader's parts a batch of 4 over the demo list
  (decode, the rest of the item, collate; uint8 and host-transform
  recipes); and, where this machine can decode mp4, the CLI
  (model_pretrain.single_run) over the bundled demo clips through
  backend="auto", its steps' data_time beside the loader's parts;
- checkpoint (a generator of its own, SEED + 4): B1 at the 448 serving
  shape (192, 785, 768), its long variant, against its plain version and
  stage by stage beside scaled_dot_product_attention; a synthetic ImageNet
  ViT-B/16 .pth (full geometry, the original repo's naming) imported by the
  trainer (-weights_from imagenet) into TimeSformer-B (divided; two steps)
  and ViViT-B (fact_encoder, Conv3d inflation, 4 temporal layers copied;
  one step), the missing and unexpected names asserted and every imported
  leaf bit-equal to the file's; the TimeSformer's trainer checkpoint
  exported by tools/export_serving.py for 224 and for 448 requests (the
  bucket-8 torch.export program, traced on the CPU in bf16, beside
  params.npz), reloaded with load_predictor both from the program and as
  the model rebuilt from the parameter names, and served, 8 clips x 3
  crops: the rebuilt model at 224 bit-equal to the trainer's weights, at
  448 (the 224 table resized on every forward) against the plain versions,
  timed and profiled; the program's logits bit-equal to the rebuilt
  model's at both sizes with the same launches, the export and load
  seconds, each served batch timed in turns; a tiny program exported on the
  CPU served on the card (bit-equal to its rebuilt model, within
  SLICE_REL_TOL of the same program on the CPU); B1's and B2's host µs to
  issue a call through the wrapper, the vt:: op, and the autograd entry
  before the ops and now (tools/fused_bench.py issue_costs); the mim
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
- sequence parallel (a generator of its own, SEED + 8): B1-B4 at
  TimeSformer-B's sequence-parallel shard shapes, sp = 2 and 4 (a rank's
  196 / sp patches: temporal rows (clips · 196 / sp, 8, 768), spatial
  rows (clips · 8 / sp, 197, 768), FFN rows clips · (1 + 196 / sp · 8)),
  train and serving, against their plain versions, rows under "phases";
  then, on this card over gloo, the worker's TimeSformer-B run over SP = 2
  (two ranks: three steps and the fit), over SP = 2 x TP = 2 (four ranks,
  one step) and ViViT-B fact_encoder at 16x224 over SP = 2 (one step,
  against this process's one-process step), each rank's steps within the
  train phase's bounds, the ranks' lines identical, each rank's launches
  and attention variants a one-process run's, each rank's peak device
  memory beside the one process's; then parallel/sp.py's ring at (8,
  1569, 768) over two gloo ranks, its output and every gradient against
  one process's B1 + B3 long (1e-2 of max|ref|), timed beside them;
- pipeline parallel (a generator of its own, SEED + 9): B1-B4 at the
  microbatches' shapes (a microbatch of c clips: temporal rows (c · 196,
  8, 768), spatial (c · 8, 197, 768), FFN rows c · 1569; forward and
  backward at c = 4 and 2, forward at the eval microbatches' 3 and 1; B1
  and B3 long at (4, 1569, 768)), against their plain versions, rows
  under "phases"; then, on this card over gloo, the worker's
  TimeSformer-B run over PP = 2 (two ranks, M = 2 microbatches of 4
  clips: three steps and the fit) and over PP = 2 at M = 4 (one step),
  and ViViT-B joint at 16x224 over PP = 2 (one step,
  B1/B3 long at (4, 1569, 768)) against this process's one-process step,
  each rank's steps within the train phase's bounds of one process, the
  ranks' lines identical, each rank's launches those of its stage's
  blocks once a microbatch, its peak device memory and its step ms by
  CUDA events and the clock; graft_entry.dryrun_multichip(4) on the card
  (dp2 x tp2 and dp2 x pp2 against one process); a stage move of (4,
  1569, 768) bf16 timed over gloo. Two ranks share the card, so these
  times are no pipeline speed and no bubble;
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
  TimeSformer-B against the plain CPU run;
- tools (the visualisation tools' seeds from a generator of their own,
  SEED + 7): tools/visualize_attention.py on a demo clip at TimeSformer-B
  8x224 (its cls rows against the plain fp32 CPU run, 23 B1 and 11 B2) and
  tools/visualize_maskfeat.py at MViT-B 16x224 (its HOG maps against the
  plain versions, both with cuDNN's deterministic algorithms; 16 B5 and 13
  B2), their PNGs not constant; the measuring twins in benchmarks/:
  trace_step's finetune and maskfeat configs (the categories summing to
  the device total, the port's kernels in it, the trace's device span
  against the CUDA events), trace_infer on both archs, profile_train,
  serve_bench for 5 s (every answer against the predictor's direct one),
  run_all's full matrix; and the port notebook's code cells, run in order
  on the card.

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
and B6 at the head-dim-64 long shapes (flash_bench.LONG_SHAPES: the
16-frame joint shape (96, 3137, 3137), ViViT-B's joint (96, 1569, 1569)
and the 448² spatial rows (2304, 785, 785)): those rows are under
"phases" and outside the totals. ViViT-B's joint attention at 32 frames
(16, 3137, 768) is timed in its two forms, the fused call the model takes
and the unfused stage (joint_forms_phase), forward and backward, in
turns, and each form is held against the fp32 plain composition there.
The last line is
{"ok": true, "device": {...}}. Its phases took 178-221 s on an H100 (the
six builds included; the data phase 22-28 s) before the checkpoint phase
was added. B3's backward phases also
time its whole call (with the projection products) beside its bound.
Before the serving path it prints B1's, B2's, B3's and B4's stages
(device ms a call) beside torch.matmul at each product's shape (and
scaled_dot_product_attention beside the long attention stage), and B2's
fc1 with and without its GELU epilogue; beside B1's and B3's long
attention stage, the stage alone by CUDA events and
scaled_dot_product_attention on q, k, v of its size, in turns.
"""

import contextlib
import copy
import gc
import glob
import importlib.util
import io
import json
import os
import shutil
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

from videotransformer_tpu_torch import graft_entry, model_pretrain
from videotransformer_tpu_torch.benchmarks import (
    profile_train, run_all, serve_bench, trace_infer, trace_step)
from videotransformer_tpu_torch.data import (
    device_augment, pipeline, video_reader)
from videotransformer_tpu_torch.data.mask_generator import (
    CubeMaskGenerator, pad_cube_marker)
from videotransformer_tpu_torch.data.transforms import eval_transform_clip
from videotransformer_tpu_torch.kernels import (
    _build, flash_attention, fused_ffn, fused_mhsa, mvit_pool)
from videotransformer_tpu_torch.models import convert, mvit
from videotransformer_tpu_torch.models.convert import split_artifact_params
from videotransformer_tpu_torch.models.timesformer import (
    TimeSformer, get_vit_base_patch16_224)
from videotransformer_tpu_torch.ops import blocks
from videotransformer_tpu_torch.ops.blocks import ClassificationHead
from videotransformer_tpu_torch.parallel import mesh as pmesh
from videotransformer_tpu_torch.serving.export import export_predictor
from videotransformer_tpu_torch.serving.predictor import (
    TorchPredictor, load_predictor, make_predict_fn)
from videotransformer_tpu_torch.serving.server import InferenceServer
from videotransformer_tpu_torch.tools import (
    export_serving, fused_bench, mp_train_worker, visualize_attention,
    visualize_maskfeat)
from videotransformer_tpu_torch.tools.flash_bench import (
    FLASH_SHAPES, HD as MVIT_HD, JOINT_HD, LONG_SHAPES, bound, flash_bounds,
    issue_us, sdpa_times, timed_ms)
from videotransformer_tpu_torch.tools.fused_bench import (
    FFN_FWD_PRODUCTS, FFN_PRODUCTS, MHSA_BWD_PRODUCTS, MHSA_PRODUCTS,
    fc1_epilogue_ms, ffn_bwd_bound, ffn_fwd_case, ffn_fwd_products,
    ffn_products, format_stages, matmul_ms, mhsa_bwd_bound, mhsa_bwd_case,
    long_stage_ms, mhsa_bwd_products, mhsa_products, stage_times)
from videotransformer_tpu_torch.training import data_module
from videotransformer_tpu_torch.training import trainer as trainer_mod
from videotransformer_tpu_torch.utils import profiling

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
             "flash_attention", "flash_attention_bwd", "mvit_pool")
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
# 16·196 = 3137 tokens: the fused call, B1 and B3 long)
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


# ViViT-B at 32x224, 16 clips a step (the benchmark's vivit_b.finetune.b16):
# joint space-time attention over 1 + 16·196 = 3137 tokens
JOINT32_SHAPE = (16, 1 + 16 * (IMG // 16) ** 2, D)


def joint_fp32(mod, x):
    """Joint attention with the residual in fp32, plain PyTorch: LayerNorm,
    the qkv product, softmax attention, the projection."""
    F = torch.nn.functional
    B, N, _ = x.shape
    a = mod.attn
    xn = F.layer_norm(x, (D,), mod.norm.weight, mod.norm.bias, 1e-5)
    q, k, v = F.linear(xn, a.qkv.weight, a.qkv.bias).reshape(
        B, N, 3, a.num_heads, a.head_dim).permute(2, 0, 3, 1, 4).unbind(0)
    o = F.scaled_dot_product_attention(q, k, v)
    return x + F.linear(o.transpose(1, 2).reshape(B, N, D), a.proj.weight,
                        a.proj.bias)


def joint_forms_phase(rng, iters=10):
    """ViViT-B's joint attention at JOINT32_SHAPE, 12 heads of 64, fp32
    parameters and bf16 tokens as the trainer runs it, in its two forms:
    the fused call (B1 forward, B3 backward, both long) that the module
    takes, and the unfused stage (LayerNorm in fp32 statistics, the qkv
    product, the layout copies, B5/B6, the projection) it took before.
    Device ms a call by CUDA events in turns (unfused, fused, fused,
    unfused): the forward with autograd recording, the backward through
    one recorded graph (every gradient); the memory autograd keeps a layer.
    The output and each gradient of each form with the residual added as
    the module adds it, against the fp32 plain composition (joint_fp32),
    over max|fp32|, held to KERNEL_REL_TOL as tests/test_torch_cuda.py
    holds them at 2 clips; the gap between the forms without the residual,
    over max|unfused|, to twice it.
    Returns {form: (forward ms, backward ms)}."""
    mod = blocks.JointAttention(D, HEADS)
    gen = torch.Generator().manual_seed(SEED)
    mod.reset_parameters(gen)
    with torch.no_grad():  # a LayerNorm that bf16 rounding can see
        mod.norm.weight.add_(0.1 * torch.randn(D, generator=gen))
        mod.norm.bias.add_(0.1 * torch.randn(D, generator=gen))
    mod = mod.to("cuda")
    x = bf16_on_card(rng, JOINT32_SHAPE, 1.0).requires_grad_()
    g = bf16_on_card(rng, JOINT32_SHAPE, 1.0)
    inputs = [x] + list(mod.parameters())
    forms = {"fused": lambda: mod._sharded(mod._fused, x),
             "unfused": lambda: mod._sharded(mod._unfused, x,
                                             mod.norm.weight.dtype)}
    fwd = {}
    grads, kept, bwd_calls = {}, {}, {}
    for form, call in forms.items():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        out = call()
        torch.cuda.synchronize()
        kept[form] = (torch.cuda.memory_allocated() - before) / 2**20
        grads[form] = [out] + list(torch.autograd.grad(
            out, inputs, g, retain_graph=True))
        bwd_calls[form] = lambda out=out: torch.autograd.grad(
            out, inputs, g, retain_graph=True)
    fwd["fused"], fwd["unfused"] = in_turns(
        forms["unfused"], forms["fused"], iters=iters, plain_iters=iters)
    bwd = dict(zip(("fused", "unfused"), in_turns(
        bwd_calls["unfused"], bwd_calls["fused"], iters=iters,
        plain_iters=iters)))
    del bwd_calls
    xf = x.detach().float().requires_grad_()
    out = joint_fp32(mod, xf)
    want = [out.detach()] + list(torch.autograd.grad(
        out, [xf] + list(mod.parameters()), g.float()))
    del out
    names = ["out", "x"] + [n for n, _ in mod.named_parameters()]
    errs = {form: {n: worst_error([f], [w])[1] for n, f, w in zip(
        names, [x.detach() + out, dx + g, *rest], want)}
        for form, (out, dx, *rest) in grads.items()}
    errs["gap"] = {n: worst_error([f], [u.float()])[1]
                   for n, f, u in zip(names, grads["fused"], grads["unfused"])}
    B, N, _ = JOINT32_SHAPE
    fb, fb_by = fused_bench.mhsa_bound(B * N, N, D)
    bb, bb_by = mhsa_bwd_bound(B * N, N, D)
    log(f"joint attention {JOINT32_SHAPE}, {HEADS} heads: forward fused "
        f"{fwd['fused']:.4f} ms ({fb / fwd['fused']:.1%} of its {fb:.4f} ms "
        f"bound, {fb_by}), unfused {fwd['unfused']:.4f} ms; backward fused "
        f"{bwd['fused']:.4f} ms ({bb / bwd['fused']:.1%} of its {bb:.4f} ms "
        f"bound, {bb_by}), unfused {bwd['unfused']:.4f} ms; kept for the "
        f"backward {kept['fused']:.1f} MiB fused, {kept['unfused']:.1f} MiB "
        f"unfused")
    for what, e in errs.items():
        log(f"joint attention {JOINT32_SHAPE} "
            + ("gap between the forms over max|unfused|" if what == "gap"
               else f"{what} against fp32 over max|fp32|") + ": "
            + ", ".join(f"{n} {v:.2e}" for n, v in e.items()))
    for what, e in errs.items():
        worst = max(e, key=e.get)
        tol = 2 * KERNEL_REL_TOL if what == "gap" else KERNEL_REL_TOL
        assert e[worst] <= tol, (what, worst, e[worst])
    return {f: (fwd[f], bwd[f]) for f in forms}


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
    """B1's or B3's long attention stage alone at x's ``shape`` (B, L, D)
    by CUDA events, and scaled_dot_product_attention on q, k, v of its size
    (1, B·H, L, D/H) beside it, in turns (fused_bench.long_stage_ms): the
    stage's own reading and the library's yardstick (the port never calls
    it)."""
    stage, lib = long_stage_ms(rng, shape, backward)
    bh, L = shape[0] * HEADS, shape[1]
    return (f"; the long attention stage alone {stage:.4f} ms (CUDA "
            f"events), scaled_dot_product_attention "
            f"{'backward' if backward else 'forward'} on q, k, v of its "
            f"size (1, {bh}, {L}, {D // HEADS}): {lib:.4f} ms (in turns)")


def by_slices(fn, *args, n=576):
    """``fn`` (a plain flash attention version) over its (1, B·H, ...)
    tensor arguments ``n`` slices at a time, its outputs put together along
    B·H: at the 448² rows (2304 slices of 785) the fp32 scores of all
    slices at once would take 5.7 GB a tensor."""
    bh = args[0].shape[1]
    if bh <= n:
        return fn(*args)
    parts = [fn(*[a[:, i:i + n] if torch.is_tensor(a) else a for a in args])
             for i in range(0, bh, n)]
    return tuple(torch.cat(p, 1) for p in zip(*parts))


def flash_phases(rng, cases=None):
    """B5 and B6 at each (B·H, Nq, Nkv) of a batch-8 mim step, head dim 96,
    and at the head-dim-64 long shapes (``cases``: TimeSformer-B's 16-frame
    joint attention (96, 3137, 3137), ViViT-B's joint (96, 1569, 1569), the
    448² spatial rows (2304, 785, 785); not in the mim step's totals): each
    against its plain version run in fp32 from the same bf16 inputs
    (B6 from the kernel's own o and lse, every gradient; by_slices); B6
    twice to the bit; times in turns
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
        want_o, _ = by_slices(fa._forward_reference, q.float(), k.float(),
                              v.float(), scale)
        fwd_err = worst_error([o], [want_o])
        del want_o
        want_b = by_slices(fa.flash_attention_backward_reference, q.float(),
                           k.float(), v.float(), o.float(), lse, do.float(),
                           scale)
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

        ms, plain_ms = in_turns(
            lambda: by_slices(fa._forward_reference, q, k, v, scale),
            lambda: fa._launch(q, k, v, scale))
        b_ms, b_plain_ms = in_turns(
            lambda: by_slices(fa.flash_attention_backward_reference, q, k, v,
                              o, lse, do, scale),
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

def profile_forward(forward, event_ms, n=3, what="forward", ranges=()):
    """Device kernels of ``n`` calls of ``forward`` under ``torch.profiler``:
    device ms per call for each kernel name, the device's busy share between
    the first kernel's start and the last kernel's end, and the summed
    kernel time over ``event_ms`` (one call by CUDA events, unprofiled)
    (``profiling.summarize``); the same time split by the code the kernels
    come from (``profiling.kernel_source``); then for each
    ``record_function`` range named in ``ranges`` the device time of the
    kernels launched inside it. Returns the summed kernel time per call
    (None when the trace has none)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # first session: profiler start-up
        forward()
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(n):
            forward()
        torch.cuda.synchronize()
    summary = profiling.summarize(
        profiling.profile_spans(prof, "cuda", exclude=ranges), n)
    if summary is None:
        log("profile: no device events in the trace; not measured")
        return
    per_name, summed = summary["per_name"], summary["total_ms"]
    log(f"profile ({n} x {what}): device kernel time {summed:.3f} ms per "
        f"{what} against {event_ms:.3f} ms by CUDA events unprofiled "
        f"(ratio {summed / event_ms:.3f}); busy share of the traced device "
        f"span {summary['busy_share']:.4f}, idle share "
        f"{summary['idle_share']:.4f}")
    by_source = profiling.group(per_name, profiling.kernel_source)
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
# MViT's pools (kernels/mvit_pool.py), a block's three pools a call, read
# apart (read_pool_counts): only the MViT paths run them
POOL_COUNTERS = ((mvit_pool, "LAUNCHES"), (mvit_pool, "BWD_LAUNCHES"))


def reset_counts():
    for mod, attr in KERNEL_COUNTERS + POOL_COUNTERS:
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


def read_pool_counts():
    """(forward, backward) calls of the pool kernels since reset_counts."""
    return tuple(getattr(mod, attr) for mod, attr in POOL_COUNTERS)


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
                flash_attention.flash_attention_backward_reference),
            mock.patch.object(mvit_pool, "_launch",
                              mvit_pool._forward_reference),
            mock.patch.object(mvit_pool, "_launch_backward",
                              mvit_pool._backward_reference)]


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
    fused call past FUSED_MHSA_MAX_N at head dim 64, B1 and B3 long)
    through the kernels against the same step through the plain versions.
    Returns the launches."""
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
    want = {"fused_prenorm_mhsa": TYPES_DEPTH, "fused_prenorm_ffn": TYPES_DEPTH,
            "fused_prenorm_mhsa_bwd": TYPES_DEPTH,
            "fused_prenorm_ffn_bwd": TYPES_DEPTH, "flash_attention": 0,
            "flash_attention_bwd": 0}
    check_steps(f"TimeSformer-B joint 16x{IMG} ({TYPES_DEPTH} layers)", steps,
                plain, want, variants(long=TYPES_DEPTH),
                variants(long=TYPES_DEPTH))
    for n in KERNEL_NAMES:
        launches[n] += steps[0]["launches"][n]
    return launches


# ---------------------------------------------------------------- mim

MIM_WANT = {"fused_prenorm_mhsa": 0, "fused_prenorm_ffn": 13,
            "fused_prenorm_mhsa_bwd": 0, "fused_prenorm_ffn_bwd": 13,
            "flash_attention": 16, "flash_attention_bwd": 16}
# the pool kernels' (forward, backward) calls a mim step: one a block each
# way (every block pools k and v; blocks 1 and 3 q too), 34 pools
MIM_POOL_WANT = (16, 16)
POOL_CLIPS = 32  # the pool phase's batch: the benchmark's MaskFeat cell's
# the old path's cuDNN kernels, one launch a channel or a transpose around
# them, which no pool may launch now
POOL_CUDNN_KERNELS = ("convolveNd", "dgrad2d_grouped", "tensorTransformGeneric")


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
                      "pools": read_pool_counts(),
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
    # the plain versions' pools are cuDNN's convolutions, whose default
    # backward is not reproducible, and AdamW's first updates (about
    # lr·sign(g)) carry that noise to ~1e-3 of the loss by the third step:
    # the compared runs take the deterministic algorithms, so each repeats
    # to the bit (mim_repeats holds the kernels' steps to it without them).
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
        assert k["pools"] == MIM_POOL_WANT, (i, k["pools"])
        assert not any(p["launches"].values()), p["launches"]
        assert p["pools"] == (0, 0), p["pools"]
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
    pools_off_cudnn(step)
    mim_repeats(tree, batch)
    return launches, tr, batch


def pools_off_cudnn(step):
    """One traced mim step with cuDNN's default algorithms: cuDNN runs the
    patch embed's convolution alone (one aten::cudnn_convolution and one
    aten::convolution_backward a step), no kernel of the pools' old cuDNN
    path is launched (POOL_CUDNN_KERNELS), and the pool kernels launch once
    a block forward and three times backward; their device ms and the
    convolution kernels' are printed by name."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # first session: profiler start-up
        step()
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    ops, kernels = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            ops[e.name] = ops.get(e.name, 0) + 1
        elif not e.is_user_annotation:
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += (e.time_range.end - e.time_range.start) / 1e3
    pools = {n: v for n, v in kernels.items()
             if n.removeprefix("void ").startswith("vt::mvit_pool")}
    conv = {n: v for n, v in kernels.items() if n not in pools and (
        profiling.kernel_source(n) == "cuDNN" or "conv" in n.lower()
        or "xmma" in n.lower())}
    log(f"mim step, traced (cuDNN default algorithms): aten::cudnn_"
        f"convolution {ops.get('aten::cudnn_convolution', 0)}, aten::"
        f"convolution_backward {ops.get('aten::convolution_backward', 0)} "
        f"a step; pool kernels " + ", ".join(
            f"{n[:40]} {c} x {ms:.3f} ms" for n, (c, ms) in pools.items())
        + f" ({sum(v[1] for v in pools.values()):.3f} ms); convolution "
        f"kernels " + ", ".join(f"{n[:60]} {c} x {ms:.3f} ms"
                                for n, (c, ms) in conv.items()))
    assert ops.get("aten::cudnn_convolution", 0) == 1, ops
    assert ops.get("aten::convolution_backward", 0) == 1, ops
    assert not [n for n in kernels if any(k in n for k in POOL_CUDNN_KERNELS)
                ], conv
    assert sum(c for c, _ in pools.values()) == 4 * MIM_POOL_WANT[0], pools


def mim_repeats(tree, batch):
    """Two mim steps from one state, twice, with cuDNN's default algorithms
    (the benchmark's setting): losses, grad norms and every parameter equal
    to the bit."""
    runs = []
    for _ in range(2):
        tr = trainer_mod.VideoTransformerTrainer(mim_configs(), "cuda",
                                                 params=tree)
        stats = [tr.train_step(batch, MIM_LR, MIM_WD) for _ in range(2)]
        runs.append(([(float(st["loss"]), float(st["grad_norm"]))
                      for st in stats],
                     {n: p.detach().clone()
                      for n, p in tr.optimizer.params.items()}))
        del tr
    (a, pa), (b, pb) = runs
    differ = [n for n in pa if not torch.equal(pa[n], pb[n])]
    log(f"mim steps from one state, twice (cuDNN default algorithms): "
        f"(loss, grad_norm) {a} and {b}; parameters that differ: "
        f"{len(differ)} of {len(pa)} {differ[:4]}")
    assert a == b and not differ, (a, b, differ)


def mvit_pool_blocks():
    """(grid, C, head dim, geometry) of each block of the trainer's MaskFeat
    at 16x224: the token grid the block sees and its pools' (kernel,
    stride), or None, for q, k and v."""
    model = trainer_mod.build_model(mim_configs())
    thw, out = model.mvit.patch_embed_shape, []
    for blk in model.mvit.blocks:
        pools = (blk.attn.pool_q, blk.attn.pool_k, blk.attn.pool_v)
        hd = next(p.weight.shape[0] for p in pools if p is not None)
        out.append((thw, blk.dim, hd, tuple(
            None if p is None else (p.kernel, p.stride) for p in pools)))
        if blk.attn.pool_q is not None:
            thw = mvit_pool.out_grid(thw, blk.attn.pool_q.kernel,
                                     blk.attn.pool_q.stride)
    return out


def _touched(n, k, s):
    """Positions of a length-n axis that a pool's windows read."""
    out = (n + 2 * (k // 2) - k) // s + 1
    return len({o * s - k // 2 + i for o in range(out) for i in range(k)}
               & set(range(n)))


def pool_bytes(B, thw, C, geometry):
    """(forward, backward) bytes a block's pools must move, each once: the
    input positions their windows read and the outputs; the whole d_qkv
    written, the output gradients (a slice without a pool: its gradient)
    and the input positions read."""
    L = int(np.prod(thw))
    fwd, bwd = 0, 2 * B * L * 3 * C
    for g in geometry:
        if g is None:
            bwd += 2 * B * L * C
            continue
        read = 2 * B * C * int(np.prod([_touched(n, k, s) for n, k, s in zip(
            thw, *g)]))
        out = 2 * B * C * int(np.prod(mvit_pool.out_grid(thw, *g)))
        fwd, bwd = fwd + read + out, bwd + read + out
    return fwd, bwd


def mvit_pool_phase(rng, card):
    """The pool kernels at every block of a MaskFeat step at POOL_CLIPS
    clips (16 calls, 34 pools), against the plain version in fp32 from the
    same bf16 operands (the weight rounded to bf16, as the kernels round
    it), forward and backward, each twice to the bit; timed beside the
    plain version as the program ran it before (bf16 slices through
    F.conv3d, forward and backward by autograd) and cuDNN's conv3d alone on
    dense (B, C, T, H, W) operands with the tiled weight (the yardstick:
    the port never calls it), and each direction's bound. Returns the
    kernel report's entry."""
    rows = []
    for i, (thw, C, hd, geometry) in enumerate(mvit_pool_blocks()):
        B = POOL_CLIPS
        qkv = bf16_on_card(rng, (B, int(np.prod(thw)), 3 * C), 1.0)
        weights = [None if g is None else torch.from_numpy(
            rng.standard_normal((hd, 1, *g[0]), dtype=np.float32) * 0.1
        ).to("cuda") for g in geometry]
        pooled = [j for j, g in enumerate(geometry) if g is not None]
        reset_counts()
        outs = mvit_pool._launch(qkv, thw, geometry, weights)
        again = mvit_pool._launch(qkv, thw, geometry, weights)
        grads = [bf16_on_card(rng, o.shape, 1.0) for o in outs]
        got = mvit_pool._launch_backward(qkv, thw, geometry, weights, grads)
        got2 = mvit_pool._launch_backward(qkv, thw, geometry, weights, grads)
        torch.cuda.synchronize()
        assert read_pool_counts() == (2, 2), read_pool_counts()
        assert all(torch.equal(outs[j], again[j]) for j in pooled), i
        assert all(a is b or torch.equal(a, b) for a, b in zip(got, got2)), i
        w32 = [None if w is None else w.to(torch.bfloat16).float()
               for w in weights]
        want = mvit_pool._forward_reference(qkv.float(), thw, geometry, w32)
        want_b = mvit_pool._backward_reference(
            qkv.float(), thw, geometry, w32, [g.float() for g in grads])
        fwd_err = worst_error([outs[j] for j in pooled],
                              [want[j] for j in pooled])
        bwd_err = worst_error([got[0]] + [got[1 + j] for j in pooled],
                              [want_b[0]] + [want_b[1 + j] for j in pooled])
        del want, want_b, again, got2

        def plain():
            x = qkv.detach().requires_grad_()
            ws = [None if w is None else w.detach().requires_grad_()
                  for w in weights]
            o = mvit_pool._forward_reference(x, thw, geometry, ws)
            torch.autograd.grad(o, [x] + [w for w in ws if w is not None],
                                grads)

        dense = []
        for j in pooled:
            kernel, stride = geometry[j]
            grid = mvit_pool.out_grid(thw, kernel, stride)
            dense.append((
                qkv[..., j * C:(j + 1) * C].reshape(B, *thw, C).permute(
                    0, 4, 1, 2, 3).contiguous().requires_grad_(),
                weights[j].to(torch.bfloat16).repeat(
                    C // hd, 1, 1, 1, 1).requires_grad_(),
                grads[j].reshape(B, *grid, C).permute(0, 4, 1, 2, 3
                                                      ).contiguous(),
                kernel, stride))

        def library():
            for x5, w5, dy5, kernel, stride in dense:
                y = torch.nn.functional.conv3d(
                    x5, w5, stride=stride, padding=[k // 2 for k in kernel],
                    groups=C)
                torch.autograd.grad(y, (x5, w5), dy5)

        fwd_ms = timed_ms(lambda: mvit_pool._launch(
            qkv, thw, geometry, weights), iters=10)
        bwd_ms = timed_ms(lambda: mvit_pool._launch_backward(
            qkv, thw, geometry, weights, grads), iters=10)
        plain_ms = timed_ms(plain, iters=2, warmup=1)
        library_ms = timed_ms(library, iters=2, warmup=1)
        fwd_b, bwd_b = (n / 3.35e9 for n in pool_bytes(B, thw, C, geometry))
        rows.append({"block": i, "grid": list(thw), "C": C, "head_dim": hd,
                     "pools": [None if g is None else [list(g[0]), list(g[1])]
                               for g in geometry],
                     "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "ms": fwd_ms + bwd_ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_fwd_ms": fwd_b, "bound_bwd_ms": bwd_b,
                     "bound_ms": fwd_b + bwd_b, "fwd_err": fwd_err[1],
                     "bwd_err": bwd_err[1]})
        log(f"pools, block {i} ({B} clips, grid {thw}, C {C}, "
            f"{len(pooled)} pools {[geometry[j] for j in pooled]}): "
            f"forward {fwd_ms:.4f} ms (bound {fwd_b:.4f}, err "
            f"{fwd_err[1]:.2e}), backward {bwd_ms:.4f} ms (bound "
            f"{bwd_b:.4f}, err {bwd_err[1]:.2e}); plain versions in bf16 "
            f"{plain_ms:.3f} ms, cuDNN alone {library_ms:.3f} ms, forward "
            f"and backward")
        assert max(fwd_err[1], bwd_err[1]) <= KERNEL_REL_TOL, rows[-1]
        del qkv, outs, got, grads, dense
        torch.cuda.empty_cache()
    total = {k: sum(r[k] for r in rows) for k in (
        "fwd_ms", "bwd_ms", "ms", "plain_ms", "library_ms", "bound_fwd_ms",
        "bound_bwd_ms", "bound_ms")}
    log(f"pools, a MaskFeat step at {POOL_CLIPS} clips on {card}: "
        f"kernels {total['ms']:.3f} ms (forward {total['fwd_ms']:.3f}, "
        f"backward {total['bwd_ms']:.3f}) against the bound "
        f"{total['bound_ms']:.3f} ms "
        f"({100 * total['bound_ms'] / total['ms']:.1f}%), plain versions {total['plain_ms']:.3f} ms, cuDNN alone "
        f"{total['library_ms']:.3f} ms; worst error "
        f"{max(max(r['fwd_err'], r['bwd_err']) for r in rows):.2e}")
    return {"name": "mvit_pool", "route": "cuda",
            "source": "videotransformer_tpu_torch/csrc/mvit_pool.cu",
            "replaces": None, **total,
            "max_rel_err": max(max(r["fwd_err"], r["bwd_err"]) for r in rows),
            "phases": rows}


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
        f"{float(stats['grad_norm']):.6f}, launches {launches}, pools "
        f"{read_pool_counts()}")
    assert np.isfinite([float(stats["loss"]), float(stats["grad_norm"])]).all()
    assert launches == MIM_WANT, launches
    assert read_pool_counts() == MIM_POOL_WANT, read_pool_counts()
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
        assert read_pool_counts() == (MIM_POOL_WANT[0], 0), read_pool_counts()
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


# ---------------------------------------------------------------- decode

# the bundled demo clips (12 mp4s, 192 x 256, 40 frames at 25 fps) and the
# CLI's recipe over them: batch 4, 4 loader threads, TimeSformer-B
DEMO = "videotransformer_tpu/data/assets/demo"
DEMO_BATCH, DEMO_WORKERS = 4, 4
DEMO_ARGS = [
    "-epoch", "1", "-batch_size", str(DEMO_BATCH), "-num_workers",
    str(DEMO_WORKERS), "-num_class", "4", "-num_frames", str(FRAMES),
    "-frame_interval", "4", "-objective", "supervised", "-arch",
    "timesformer", "-lr", "0.005", "-warmup_epochs", "1",
    "-train_data_path", f"{DEMO}/demo_train_list.txt", "-classmap_path",
    f"{DEMO}/demo_classmap.json", "-device", "cuda", "-log_interval", "1"]
# native against OpenCV, as tests/test_data.py::test_native_decoder_matches_cv2
# holds them: chroma upsampling and the YUV -> RGB rounding differ (swscale
# bilinear against OpenCV's conversion), by a mean of ~1-2 of 255
DECODE_MEAN_ABS_TOL = 4.0
DECODE_REPS = 5  # timed passes over the demo list, after one untimed


def ffmpeg_headers():
    """(include directories holding libavformat's headers, pkg-config's
    libavformat version or None) on this machine."""
    dirs = sorted(glob.glob("/usr/include/libavformat")
                  + glob.glob("/usr/include/*/libavformat")
                  + glob.glob("/usr/local/include/libavformat"))
    version = None
    if shutil.which("pkg-config"):
        proc = subprocess.run(["pkg-config", "--modversion", "libavformat"],
                              capture_output=True, text=True)
        version = proc.stdout.strip() if proc.returncode == 0 else None
    return dirs, version


def decode_decision():
    """The decode line, decided before the decode phase starts: the
    backend that backend="auto" picked (building the native decoder if it
    can; for cv2 the compiler's error), whether FFmpeg's headers are here,
    and whether OpenCV is. Returns (backend, OpenCV present)."""
    t0 = time.perf_counter()
    backend, error = video_reader.auto_backend()
    seconds = time.perf_counter() - t0
    dirs, version = ffmpeg_headers()
    has_cv2 = importlib.util.find_spec("cv2") is not None
    why = (f"libvideodec.so built or loaded in {seconds:.2f} s" if error is None
           else f"the native build failed: {error}")
    log(f"decode: backend=auto picked {backend} ({why}); FFmpeg headers: "
        f"{', '.join(dirs) or 'none found'} (pkg-config libavformat: "
        f"{version or 'not found'}); OpenCV: "
        f"{'present' if has_cv2 else 'absent'}")
    return backend, has_cv2


def demo_data(device_augment):
    """The CLI's data module over the demo list (KineticsDataModule, as
    single_run builds it): uint8 clips for the device augment, or the host
    transforms."""
    args = model_pretrain.parse_args(DEMO_ARGS + [
        "-root_dir", ".", "-device_augment", str(device_augment)])
    return data_module.KineticsDataModule(args, args.train_data_path)


def native_against_cv2():
    """Every demo clip through both backends at the JAX test's bounds: the
    same length and fps, a mean abs difference below DECODE_MEAN_ABS_TOL,
    the next frame a worse match, unsorted indices back in request order."""
    worst, margin = 0.0, float("inf")
    paths = sorted(glob.glob(f"{DEMO}/*.mp4"))
    for path in paths:
        vr = video_reader.VideoReader(path, backend="native")
        cv = video_reader.VideoReader(path, backend="cv2")
        try:
            assert len(vr) == len(cv) and vr.fps == cv.fps, path
            idx = np.linspace(0, len(vr) - 1, 8).astype(np.int64)
            got, want = vr.get_batch(idx).astype(int), \
                cv.get_batch(idx).astype(int)
            diff = np.abs(got - want).mean()
            nxt = cv.get_batch([idx[3] + 1])[0].astype(int)
            d_same = np.abs(got[3] - want[3]).mean()
            d_next = np.abs(got[3] - nxt).mean()
            shuffled = vr.get_batch(idx[::-1].copy())
        finally:
            vr.close()
            cv.close()
        assert diff < DECODE_MEAN_ABS_TOL, (path, diff)
        assert d_same < d_next, (path, d_same, d_next)
        assert (shuffled == got[::-1]).all(), path
        worst, margin = max(worst, diff), min(margin, d_next - d_same)
    log(f"decode: native against cv2 on {len(paths)} demo clips: worst mean "
        f"|native - cv2| {worst:.4f} of 255 (tol {DECODE_MEAN_ABS_TOL}); "
        f"the next frame a worse match on every clip (smallest margin "
        f"{margin:.4f}); unsorted indices back in request order")
    return worst


def decode_ms_per_clip(backend, card):
    """The dataset's raw read (Kinetics(raw_clips=True)._decode: FRAMES
    frames at short edge 256 over a random window) of every demo clip
    through ``backend``, on the host clock: the median of DECODE_REPS
    passes after one, divided by the clips."""
    raw = demo_data(True).train_dataset
    with mock.patch.object(video_reader, "_auto", (backend, None)):
        passes = []
        for _ in range(1 + DECODE_REPS):
            t0 = time.perf_counter()
            for i in range(len(raw)):
                _, video = raw._decode(i)
                assert video.shape == (FRAMES, 256, 341, 3), video.shape
            passes.append((time.perf_counter() - t0) * 1e3 / len(raw))
    ms = float(np.median(passes[1:]))
    log(f"decode: {backend} {ms:.3f} ms per clip ({FRAMES} frames at short "
        f"edge 256, the dataset's raw read over {len(raw)} demo clips; "
        f"median of {DECODE_REPS} passes after one: "
        f"{', '.join(f'{v:.3f}' for v in passes[1:])}) on the host of {card}")
    return ms


def loader_parts(device_augment, card):
    """One thread's ms a batch of DEMO_BATCH over the demo list, split into
    the decode (the default backend), the rest of the dataset's item (the
    host transforms, or the raw clip's crop and pad) and the collate; the
    median of the list's batches, after one untimed pass."""
    data = demo_data(device_augment)
    ds = data.train_dataset
    collate = pipeline.collate_raw if device_augment else \
        pipeline.collate_supervised
    decode = ds._decode
    spent = [0.0]

    def timed_decode(index):
        t0 = time.perf_counter()
        out = decode(index)
        spent[0] += time.perf_counter() - t0
        return out

    rows = []
    with mock.patch.object(ds, "_decode", timed_decode):
        for rep in range(2):
            for b in range(0, len(ds) - DEMO_BATCH + 1, DEMO_BATCH):
                spent[0] = 0.0
                t0 = time.perf_counter()
                samples = [ds[i] for i in range(b, b + DEMO_BATCH)]
                t1 = time.perf_counter()
                batch = collate(samples)
                t2 = time.perf_counter()
                if rep:
                    rows.append(((spent[0]) * 1e3,
                                 (t1 - t0 - spent[0]) * 1e3, (t2 - t1) * 1e3))
    key = "raw_video" if device_augment else "video"
    assert batch[key].shape[0] == DEMO_BATCH, batch[key].shape
    parts = dict(zip(("decode_ms", "item_ms", "collate_ms"),
                     np.median(np.array(rows), axis=0).tolist()))
    what = "uint8 clips (crop/pad), collate_raw" if device_augment else \
        f"host transforms_train({IMG}), collate_supervised"
    log(f"loader parts ({what}): one thread, a batch of {DEMO_BATCH}: "
        f"decode {parts['decode_ms']:.3f} ms, rest of the item "
        f"{parts['item_ms']:.3f} ms, collate {parts['collate_ms']:.3f} ms "
        f"(median of {len(rows)} batches) on the host of {card}")
    return parts


def decode_phase(card, backend, has_cv2):
    """Where the native decoder built: it against OpenCV on every demo
    clip, and both backends' ms per clip. Then the loader's parts for both
    recipes over the default backend. Returns the numbers."""
    numbers = {"auto_backend": backend, "decode_ms_per_clip": {}}
    if backend == "native" and has_cv2:
        numbers["native_vs_cv2_mean_abs"] = native_against_cv2()
    for b in ("native", "cv2"):
        if b == "cv2" and not has_cv2 or b == "native" and backend != b:
            log(f"decode: {b} not timed (unavailable on this machine)")
            continue
        numbers["decode_ms_per_clip"][b] = decode_ms_per_clip(b, card)
    numbers["loader_parts_ms"] = {
        "device_augment": loader_parts(True, card),
        "host": loader_parts(False, card)}
    return numbers


def cli_over_demo_clips(card, backend, has_cv2):
    """The port's CLI on the bundled demo clips, where this machine can
    decode mp4 (the native decoder or OpenCV): TimeSformer-B at full width,
    1 epoch of batch 4 with -device_augment True, decoding through
    backend="auto". Decided before the phase starts. Returns the steps'
    (time, data_time) in s from its log, or None."""
    if backend == "cv2" and not has_cv2:
        log("CLI over the demo clips: did not run; this machine has neither "
            "the native decoder nor OpenCV, and the port decodes mp4 only "
            "through them")
        return None
    log(f"CLI over the demo clips: decoding through backend=auto "
        f"({backend}), running single_run")
    with tempfile.TemporaryDirectory() as root:
        trainer = model_pretrain.single_run(DEMO_ARGS + [
            "-root_dir", root, "-device_augment", "True"])
        (train_log,) = glob.glob(f"{root}/results/*/log/train.log")
        with open(train_log) as f:
            steps = [(float(ln.split(" time ")[1].split()[0]),
                      float(ln.split(" data_time ")[1].split()[0]))
                     for ln in f if " data_time " in ln]
    log(f"CLI over the demo clips: {trainer.global_step} steps on {card}, "
        f"decoded by {backend}; step time / data_time (s): "
        f"{', '.join(f'{t:.3f} / {d:.3f}' for t, d in steps)}")
    assert trainer.global_step == 3, trainer.global_step
    assert len(steps) == 3, steps
    return steps


def data_phase(predictor, card):
    """The data path: the augment on the card against the CPU, training
    from uint8 clips, raw-uint8 serving, the decoders and the loader's
    parts over the demo clips, the CLI over them. Its own generator: the
    earlier phases' weights and clips stay as they were. Returns the
    launches of the main-path runs (the uint8 fit and the raw serving) and
    the numbers."""
    rng = np.random.default_rng(SEED + 4)
    aug = augment_check(rng, card)
    fit_launches, train = uint8_train(rng, card)
    torch.cuda.empty_cache()
    serve_launches = raw_serving(rng, predictor, card)
    backend, has_cv2 = decode_decision()
    decode = None
    if backend == "native" or has_cv2:
        decode = decode_phase(card, backend, has_cv2)
    cli_steps = cli_over_demo_clips(card, backend, has_cv2)
    if decode is not None and cli_steps is not None:
        parts = decode["loader_parts_ms"]["device_augment"]
        batch_ms = sum(parts.values())
        log(f"loader against the step: one thread makes a batch of "
            f"{DEMO_BATCH} uint8 clips in {batch_ms:.3f} ms ({backend}), "
            f"{DEMO_WORKERS} threads one in ~{batch_ms / DEMO_WORKERS:.3f} "
            f"ms; the CLI's steps 2-3 took "
            f"{', '.join(f'{t * 1e3:.1f}' for t, _ in cli_steps[1:])} ms "
            f"with data_time "
            f"{', '.join(f'{d * 1e3:.1f}' for _, d in cli_steps[1:])} ms; "
            f"the uint8 fit's data wait (no decode) "
            f"{', '.join(f'{v:.2f}' for v in train['data_ms'])} ms")
    launches = {n: fit_launches[n] + serve_launches[n] for n in KERNEL_NAMES}
    return launches, {"augment_ms": aug, **train, "decode": decode,
                      "cli_steps_s": cli_steps}


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
    ``img_size`` requests written to ``out`` (the program of bucket
    ``CLIPS``, traced on the CPU in bf16); loaded back on the card twice:
    served from the program, and by the model rebuilt from the parameter
    names (``programs=False``, the direct predictor). Returns (program
    predictor, direct predictor, {export, load of each: seconds})."""
    t0 = time.perf_counter()
    export_serving.main(["--out", out, "--ckpt", ckpt, "--ckpt_format",
                         "port", "--num_frames", str(FRAMES), "--num_class",
                         str(CLASSES), "--img_size", str(img_size),
                         "--buckets", str(CLIPS)])
    t1 = time.perf_counter()
    program = load_predictor(out, "cuda")
    t2 = time.perf_counter()
    direct = load_predictor(out, "cuda", programs=False)
    seconds = {"export": t1 - t0, "load_program": t2 - t1,
               "load_direct": time.perf_counter() - t2}
    assert program.model is None and program.dtype == torch.bfloat16
    log(f"checkpoint export at {img_size}: tools/export_serving.py "
        f"{seconds['export']:.2f} s (params.npz and the bucket-{CLIPS} "
        f"program), load from the program {seconds['load_program']:.2f} s, "
        f"the rebuilt model {seconds['load_direct']:.2f} s")
    return program, direct, seconds


def program_against_direct(program, direct, clips, what, attention, card):
    """The same batch served from the program and by the direct predictor
    on the card: the logits to the bit, the same launches and attention
    kernels; then each timed in turns (direct, program, program, direct):
    the forward alone on the batch already on the card in bf16 (CUDA
    events over 10 calls), and the whole call, numpy in, numpy out (5).
    Returns the program run's launches."""
    got, counts, kernels = served_forward(program, clips)
    want, want_counts, want_kernels = served_forward(direct, clips)
    log(f"checkpoint serving at {what} from the program: launches {counts}, "
        f"attention {kernels}; logits bit-equal to the direct predictor's "
        f"{np.array_equal(got, want)} (max|diff| "
        f"{np.abs(got - want).max():.3e})")
    assert np.array_equal(got, want)
    assert counts == want_counts and kernels == want_kernels == attention, \
        (counts, want_counts, kernels)
    batch = torch.from_numpy(clips).to("cuda", torch.bfloat16)
    forward, whole = {}, {}
    with torch.inference_mode():
        for name, pred in (("direct", direct), ("program", program),
                           ("program", program), ("direct", direct)):
            forward.setdefault(name, []).append(timed_ms(
                lambda: pred._predict(batch), iters=10, warmup=2,
                queued=False))
            whole.setdefault(name, []).append(timed_ms(
                lambda: pred(clips), iters=5, warmup=1, queued=False))
    turns = lambda t: "/".join(f"{v:.2f}" for v in t)
    log(f"checkpoint serving at {what}: a batch of {CLIPS} clips x {CROPS} "
        f"crops, the forward on the card program {turns(forward['program'])}"
        f" ms, direct predictor {turns(forward['direct'])} ms; the whole "
        f"call (numpy in, numpy out) program {turns(whole['program'])} ms, "
        f"direct {turns(whole['direct'])} ms (each turn's mean, in turns "
        f"direct, program, program, direct) on {card}")
    return counts


def tiny_program_on_card(tmp):
    """A tiny TimeSformer (128 wide, 2 heads of 64, 2 layers, 4 frames at
    32²) exported on the CPU in bf16 and served on the card: its logits
    bit-equal to the rebuilt model's on the card, through B1 (4 calls) and
    B2 (2), and within SLICE_REL_TOL of the same program on the CPU (the
    plain versions). Returns the card run's launches."""
    g = torch.Generator().manual_seed(SEED + 11)
    model = TimeSformer(num_frames=4, img_size=32, embed_dims=128,
                        num_heads=2, num_transformer_layers=2)
    model.reset_parameters(g)
    head = ClassificationHead(CLASSES, 128)
    head.reset_parameters(g)
    out = os.path.join(tmp, "tiny")
    export_predictor(out, model, head, num_frames=4, num_class=CLASSES,
                     img_size=32, buckets=(2,))
    clips = np.random.default_rng(SEED + 11).standard_normal(
        (2, CROPS, 4, 3, 32, 32), dtype=np.float32)
    got, counts, _ = served_forward(load_predictor(out, "cuda"), clips)
    want, want_counts, _ = served_forward(
        load_predictor(out, "cuda", num_heads=2, programs=False), clips)
    on_cpu = load_predictor(out, "cpu")(clips)
    err = np.abs(got - on_cpu).max()
    scale = np.abs(on_cpu).max()
    log(f"tiny program exported on the CPU, served on the card: launches "
        f"{counts}; bit-equal to the rebuilt model on the card "
        f"{np.array_equal(got, want)}; against the program on the CPU (the "
        f"plain versions) max|diff| {err:.3e}, rel {err / scale:.3e} (tol "
        f"{SLICE_REL_TOL})")
    assert np.array_equal(got, want) and counts == want_counts
    assert counts["fused_prenorm_mhsa"] == 4 and \
        counts["fused_prenorm_ffn"] == 2, counts
    assert err <= SLICE_REL_TOL * scale, (err, scale)
    return counts


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
    backbone, fp32 head) on the same clips: bit-equal. Returns (launches,
    the clips)."""
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
    return counts, clips


def serve_at_448(predictor, rng, card):
    """8 clips x 3 crops at 448² through the predictor exported for 448
    (a 224 model, its table resized on every forward): the head set by
    prototype_head from the plain features, the served logits against the
    same forward through the plain versions (SLICE_REL_TOL, argmax equal by
    a margin >= 1), B1 long 12 and packed 12; then timed and profiled.
    Returns (launches, the clips)."""
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
    return counts, clips


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

    program, direct, _ = export_from_checkpoint(ckpt, os.path.join(
        tmp, "a224"), IMG)
    counts, clips = serve_at_224(direct, tr, rng)
    add(counts)
    add(program_against_direct(program, direct, clips, IMG,
                               TIMESFORMER_ATTENTION, card))
    del program, direct, tr
    torch.cuda.empty_cache()
    program, direct, _ = export_from_checkpoint(ckpt, os.path.join(
        tmp, "a448"), HI_IMG)
    counts, clips = serve_at_448(direct, rng, card)
    add(counts)
    # the program takes the head prototype_head set on the direct predictor
    for name, t in direct.head.state_dict().items():
        program.head_params[name].copy_(t)
    add(program_against_direct(program, direct, clips, HI_IMG, HI_ATTENTION,
                               card))
    del program, direct
    torch.cuda.empty_cache()
    add(tiny_program_on_card(tmp))
    issued = fused_bench.issue_costs(np.random.default_rng(SEED + 12))
    for name, us in issued.items():
        log(f"{name} host us to issue a call (tools/fused_bench.py "
            f"issue_costs, serving shape, inference mode): " + ", ".join(
                f"{way} {t:.1f}" for way, t in us.items())
            + f"; the op registration adds {us['entry'] - us['entry_before']:.1f}"
            f" us to the entry on {card}")

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
    launch["peak_gib"] = next((float(ln.split()[1]) for ln in lines
                               if ln.startswith("PEAK_GIB ")), None)
    return steps, same, launch


def run_in_process(args, mesh=None):
    """The worker's run here, the counts from 0 before it: (its output as
    one string, its launches, its trainer, its peak device memory in GiB
    above what was allocated before it)."""
    reset_counts()
    lines = []
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr = mp_train_worker.run(args, "cuda", mesh, out=lines.append)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    launch = mp_train_worker.launches()
    return "\n".join(lines + [f"LAUNCHES {json.dumps(launch)}",
                              "WORKER OK"]), launch, tr, peak


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


def spawn_workers(tmp, what, extra, world=2, base=PARALLEL_ARGS):
    """``world`` workers of the run ``what`` on this card over gloo."""
    store = f"file://{os.path.join(tmp, what)}"
    return [subprocess.Popen(
        [sys.executable, "-m", "videotransformer_tpu_torch.tools."
         "mp_train_worker", "--rank", str(r), "--world", str(world),
         "--init", store, "--backend", "gloo", *base, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


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
    process-group runs, this process's and the workers', the kernel rows,
    (the one-process run's steps, its peak GiB)).
    """
    report = shard_phases(np.random.default_rng(SEED + 5))
    gc.collect()
    torch.cuda.empty_cache()
    args = mp_train_worker.parse_args(PARALLEL_ARGS)
    ref_out, _, ref_tr, ref_peak = run_in_process(args)
    ref_steps, ref_same, _ = parse_worker(ref_out)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pg_") as tmp:
        device = pmesh.init_distributed(
            backend="nccl", init_method=f"file://{tmp}/nccl", rank=0,
            world_size=1, device="cuda")
        try:
            mesh = pmesh.create_mesh(model=1, device=device)
            pg_out, launches, pg_tr, _ = run_in_process(args, mesh)
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
    return launches, report, (ref_steps, ref_peak)


# ------------------------------------------------------ sequence parallel

SP_DEGREES = (2, 4)
PATCHES = (IMG // 16) ** 2
SP_ONE_STEP = ["--steps", "1", "--eval_clips", "0"]
# ViViT-B fact_encoder at 16x224 (the CLI's other -sp type), one step
SP_VIVIT_ARGS = ["--model", "b16", "--device", "cuda", "--clips",
                 str(TRAIN_CLIPS), "--drop_path", "0.1", "--lr",
                 str(TRAIN_LR), "--arch", "vivit", "--attention_type",
                 "fact_encoder", "--frames", str(VIVIT_FRAMES), *SP_ONE_STEP]
RING_ITERS = 3
# one rank of the ring check: JAX's layout (sp.token_chunk) of the inputs
# in ring_in.pt, a forward and backward, the weight gradients summed over
# the ranks, then RING_ITERS timed forward and backward passes
RING_RANK = """
import json, sys, time, torch
from videotransformer_tpu_torch.parallel import mesh, sp
rank, store, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dev = mesh.init_distributed("gloo", store, rank, 2, "cuda")
m = mesh.create_mesh(seq=2, device=dev)
inp = torch.load(f"{d}/ring_in.pt", map_location=dev)
n = inp["x"].shape[1]
x = sp.token_chunk(inp["x"], m).contiguous().requires_grad_()
g = sp.token_chunk(inp["g"], m).contiguous()
w = [inp[k].clone().requires_grad_() for k in inp["weights"]]
def step():
    for t in w + [x]:
        t.grad = None
    out = sp.ring_prenorm_mhsa(x, *w, 64, 64 ** -0.5, 1e-5, m, n=n)
    out.backward(g)
    return out
out = step()
grads = [t.grad.float() for t in w]
for gr in grads:
    torch.distributed.all_reduce(gr)
torch.save({"out": out.detach(), "dx": x.grad, "grads": grads},
           f"{d}/ring_out{rank}.pt")
times = []
for _ in range(%d):
    mesh.barrier(m)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    t0 = time.perf_counter()
    start.record()
    step()
    end.record()
    end.synchronize()
    times.append([start.elapsed_time(end), (time.perf_counter() - t0) * 1e3])
print("RING_MS " + json.dumps(times), flush=True)
print("PEAK_GIB", torch.cuda.max_memory_allocated(dev) / 2**30, flush=True)
torch.distributed.destroy_process_group()
print("WORKER OK", flush=True)
""" % RING_ITERS


def sp_shard_phases(rng):
    """B1-B4 at TimeSformer-B's sequence-parallel shard shapes, sp = 2 and
    4: a rank holds the cls row and the tokens of 196 / sp patches, so
    the temporal rows are (clips · 196 / sp, 8, 768), the spatial ones
    after the all-to-all (clips · 8 / sp, 197, 768) and the FFN's rows
    clips · (1 + 196 / sp · 8); train (8 clips, forward and backward) and
    serving (8 clips x 3 crops, forward) rows, against their plain
    versions; under "phases", outside the totals."""
    fwd, bwd = [], []
    for sp in SP_DEGREES:
        for what, clips in (("train", TRAIN_CLIPS), ("serving",
                                                     CLIPS * CROPS)):
            tag = f", {what}, sp={sp}"
            temporal = (clips * PATCHES // sp, FRAMES, D)
            spatial = (clips * FRAMES // sp, 1 + PATCHES, D)
            rows = (clips * (1 + PATCHES // sp * FRAMES), D)
            cases = [("block-diagonal temporal", temporal, FRAMES),
                     ("dense spatial", spatial, 0),
                     (f"rows, hidden {4 * D}", rows, None)]
            fwd += [("fused_prenorm_mhsa" if bd is not None
                     else "fused_prenorm_ffn", f"{label} {shape}{tag}",
                     shape, bd, 1e-5, False, 1)
                    for label, shape, bd in cases]
            if what == "train":
                bwd += [("fused_prenorm_mhsa_bwd" if bd is not None
                         else "fused_prenorm_ffn_bwd",
                         f"{label} {shape}{tag}", shape, bd, 1e-5, False, 1)
                        for label, shape, bd in cases]
    with torch.inference_mode():
        report = kernel_phases(rng, fwd, SHARD_ITERS)
        report += backward_phases(rng, bwd, SHARD_ITERS)
    for e in report:
        if e["name"].startswith("fused_prenorm_mhsa"):
            want = "packed" if "temporal" in e["phase"] else "dense"
            assert e["variant"] == want, e
    return report


def check_worker_run(what, outs, ref_steps, ref_peak, want, card,
                     label="sequence parallel"):
    """Every rank's lines alike, its steps within the train phase's bounds
    of the one-process run, its launches and attention variants ``want``;
    logs each rank's peak beside the one process's. Returns the ranks'
    summed launches and the step times."""
    parsed = [parse_worker(o) for o in outs]
    steps, same, _ = parsed[0]
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    for rank, (_, same_r, launch) in enumerate(parsed):
        assert same_r == same, (what, rank, same_r, same)  # ranks alike
        counts, want_fwd, want_bwd = want
        assert {n: launch[n] for n in KERNEL_NAMES} == counts, \
            (what, rank, launch)
        assert launch["attention"] == want_fwd, (what, launch)
        assert launch["attention_bwd"] == saved_mode(want_bwd), (what, launch)
        log(f"{label} {what} rank {rank}: launches "
            f"{ {n: launch[n] for n in KERNEL_NAMES} }, B1 "
            f"{launch['attention']}, B3 {launch['attention_bwd']}; peak "
            f"{launch['peak_gib']:.3f} GiB (one process {ref_peak:.3f} GiB)")
        for n in KERNEL_NAMES:
            launches[n] += launch[n]
    assert steps and len(steps) == len(ref_steps), (what, steps)
    for i, (k, p) in enumerate(zip(steps, ref_steps)):
        dl = abs(k[0] - p[0]) / abs(p[0])
        dn = abs(k[1] - p[1]) / abs(p[1])
        log(f"{label} {what} step {i}: loss {k[0]:.6f} (one "
            f"process {p[0]:.6f}, rel {dl:.2e}, tol {LOSS_REL_TOL}), "
            f"grad_norm {k[1]:.6f} (one process {p[1]:.6f}, rel {dn:.2e}, "
            f"tol {NORM_REL_TOL}); {k[2]:.1f} ms on the clock, "
            f"{len(outs)} ranks sharing the card over gloo (correctness "
            f"only) on {card}")
        assert np.isfinite(k[:2]).all() and dl <= LOSS_REL_TOL \
            and dn <= NORM_REL_TOL, (what, i, dl, dn)
    return launches, [s[2] for s in steps], \
        [p[2]["peak_gib"] for p in parsed]


def ring_inputs(rng):
    """x, g and the weights of a prenorm MHSA at the ring's shape
    (LONG_SHAPE), bf16 on the card."""
    ln = [bf16_on_card(rng, (D,), 0.1, 1.0), bf16_on_card(rng, (D,), 0.1)]
    return {"x": bf16_on_card(rng, LONG_SHAPE, 1.0),
            "g": bf16_on_card(rng, LONG_SHAPE, 1.0),
            **dict(zip(("ln_w", "ln_b", "w_qkv", "b_qkv", "w_proj", "b_proj"),
                       ln + mhsa_weights(rng, D))),
            "weights": ["ln_w", "ln_b", "w_qkv", "b_qkv", "w_proj", "b_proj"]}


def ring_check(tmp, rng, card):
    """``sp.ring_prenorm_mhsa`` at (8, 1569, 768), sp = 2, two ranks on
    this card over gloo (JAX's layout: chunks of 785 tokens, the tail
    padded), its output and the gradients of x and every weight against
    one process's B1 + B3 long on the same bf16 inputs, each within
    KERNEL_REL_TOL of max|ref|; its forward-and-backward time beside B1 +
    B3 long's. Returns the numbers."""
    inp = ring_inputs(rng)
    torch.save(inp, os.path.join(tmp, "ring_in.pt"))
    store = f"file://{os.path.join(tmp, 'ring_store')}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", RING_RANK, str(r), store, tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    # meanwhile one process: B1 + B3, their long variant
    leaves = [inp[k].clone().requires_grad_() for k in ["x"] + inp["weights"]]
    cfg = (HEADS, (D // HEADS) ** -0.5, 1e-5, False, 0)

    def ref_step():
        for t in leaves:
            t.grad = None
        out = fused_mhsa.fused_prenorm_mhsa(*leaves, *cfg)
        out.backward(inp["g"])
        return out

    fwd_before = dict(fused_mhsa.ATTENTION_LAUNCHES)
    bwd_before = dict(fused_mhsa.ATTENTION_BWD_LAUNCHES)
    ref_out = ref_step().detach()
    assert fused_mhsa.ATTENTION_LAUNCHES["long"] == fwd_before["long"] + 1
    assert fused_mhsa.ATTENTION_BWD_LAUNCHES["long"] == \
        bwd_before["long"] + 1
    ref_grads = [t.grad.float() for t in leaves]
    ref_ms = timed_ms(ref_step, iters=5, warmup=1, queued=False)
    outs = wait_workers(procs)
    n_l = -(-LONG_SHAPE[1] // 2)
    got = [torch.load(os.path.join(tmp, f"ring_out{r}.pt"),
                      map_location="cuda") for r in range(2)]
    out = torch.cat([g["out"] for g in got], 1)[:, :LONG_SHAPE[1]]
    dx = torch.cat([g["dx"] for g in got], 1)[:, :LONG_SHAPE[1]]
    errs = {}
    for name, a, b in [("out", out, ref_out), ("dx", dx, ref_grads[0])] + [
            (f"d_{k}", got[0]["grads"][i], ref_grads[1 + i])
            for i, k in enumerate(inp["weights"])]:
        assert torch.isfinite(a).all(), name
        errs[name] = ((a.float() - b.float()).abs().max()
                      / b.float().abs().max()).item()
        assert errs[name] <= KERNEL_REL_TOL, (name, errs[name])
    ring_ms = [json.loads(ln[len("RING_MS "):]) for o in outs
               for ln in o.splitlines() if ln.startswith("RING_MS ")]
    peaks = [float(ln.split()[1]) for o in outs for ln in o.splitlines()
             if ln.startswith("PEAK_GIB ")]
    mean = lambda rows, i: sum(r[i] for r in rows) / len(rows)
    log(f"ring attention at {LONG_SHAPE} over sp=2, chunks of {n_l} tokens "
        f"(the tail padded), two ranks sharing the card over gloo: output "
        f"and every gradient against one process's B1 + B3 long, worst "
        f"max|ring-ref|/max|ref| {max(errs.values()):.3e} (tol "
        f"{KERNEL_REL_TOL}): {json.dumps(errs)}; forward and backward "
        f"{mean(ring_ms[0], 0):.2f} ms of CUDA events on rank 0, "
        f"{mean(ring_ms[0], 1):.2f} ms on its clock (a gloo run: correctness "
        f"only), against {ref_ms:.4f} ms for B1 + B3 long in one process; "
        f"peak {max(peaks):.3f} GiB a rank, on {card}")
    return {"ring_rel_err": errs, "ring_ms_rank0": ring_ms[0],
            "b1_b3_long_ms": ref_ms, "ring_peak_gib": peaks}


def sequence_parallel_phase(card, ref):
    """Sequence parallelism on the card (its own generator, SEED + 8):
    B1-B4 at the sp = 2 and 4 shard shapes (sp_shard_phases); then, all at
    once on this card over gloo, tools/mp_train_worker.py's TimeSformer-B
    (divided, 8 x 224, 8 clips, the parallel phase's run) over SP = 2 (two
    ranks, three steps and the fit epoch) and SP = 2 x TP = 2 (four ranks,
    one step), and ViViT-B fact_encoder at 16 x 224 over SP = 2 (one
    step) while this process runs its one-process step; each rank's steps
    held against the one-process run (``ref``: the parallel phase's steps
    and peak) within the train phase's bounds, the ranks' lines identical,
    each rank's launches and attention variants a one-process run's, its
    peak GiB printed beside the one process's; then the ring alone
    (ring_check). Returns (the workers' launches, the kernel rows)."""
    ref_steps, ref_peak = ref
    rng = np.random.default_rng(SEED + 8)
    report = sp_shard_phases(rng)
    gc.collect()
    torch.cuda.empty_cache()
    # a one-step worker: one TimeSformer-B forward and backward, no eval
    one_step = ({"fused_prenorm_mhsa": 2 * DEPTH, "fused_prenorm_ffn": DEPTH,
                 "fused_prenorm_mhsa_bwd": 2 * DEPTH,
                 "fused_prenorm_ffn_bwd": DEPTH, "flash_attention": 0,
                 "flash_attention_bwd": 0},
                variants(packed=DEPTH, dense=DEPTH),
                variants(packed=DEPTH, dense=DEPTH))
    wants = {"sp2": parallel_want(1), "sp2-tp2": one_step,
             "vivit-fact-sp2": VIVIT_WANT["fact_encoder"]}
    vivit_args = mp_train_worker.parse_args(SP_VIVIT_ARGS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sp_") as tmp:
        runs = {"sp2": spawn_workers(tmp, "sp2", ["--sp", "2"]),
                "sp2-tp2": spawn_workers(
                    tmp, "sp2-tp2", ["--sp", "2", "--tp", "2", *SP_ONE_STEP],
                    world=4),
                "vivit-fact-sp2": spawn_workers(
                    tmp, "vivit-fact-sp2", ["--sp", "2"],
                    base=SP_VIVIT_ARGS)}
        vivit_out, _, vivit_tr, vivit_peak = run_in_process(vivit_args)
        del vivit_tr
        gc.collect()
        torch.cuda.empty_cache()
        outs = {what: wait_workers(procs) for what, procs in runs.items()}
        refs = {"sp2": (ref_steps, ref_peak),
                "sp2-tp2": (ref_steps[:1], ref_peak),
                "vivit-fact-sp2": (parse_worker(vivit_out)[0], vivit_peak)}
        launches = dict.fromkeys(KERNEL_NAMES, 0)
        numbers = {}
        for what, worker_outs in outs.items():
            got, ms, peaks = check_worker_run(what, worker_outs, *refs[what],
                                              wants[what], card)
            for n in KERNEL_NAMES:
                launches[n] += got[n]
            numbers[f"{what}_steps_ms"] = ms
            numbers[f"{what}_peak_gib"] = peaks
            numbers[f"{what}_one_process_peak_gib"] = refs[what][1]
        numbers.update(ring_check(tmp, rng, card))
    log(f"sequence parallel numbers: {json.dumps(numbers)}")
    return launches, report


# ---------------------------------------------------------------- pipeline

PP_STAGES = 2
# ViViT-B joint at 16x224 over PP = 2, one step (B1/B3 long on each
# stage's microbatches of 4 clips, (4, 1569, 768))
PP_VIVIT_ARGS = ["--model", "b16", "--device", "cuda", "--clips",
                 str(TRAIN_CLIPS), "--drop_path", "0.1", "--lr",
                 str(TRAIN_LR), "--arch", "vivit", "--attention_type",
                 "joint_space_time", "--frames", str(VIVIT_FRAMES),
                 *SP_ONE_STEP]
# the parallel phase's eval: 3 clips in batches of 2 (one data rank), a
# test batch's rows 3 crops a clip
PP_EVAL_ROWS = (2, 1, 2 * CROPS, 1 * CROPS)
MOVE_SHAPE = (TRAIN_CLIPS // PP_STAGES, LONG_SHAPE[1], D)
MOVE_ITERS = 10
# one rank of the stage-move timing: MOVE_ITERS moves of a microbatch's
# activations from stage 0 to stage 1 over gloo, each timed by CUDA events
# on both ends and the host clock, the bits checked
MOVE_RANK = """
import json, sys, time, torch
from videotransformer_tpu_torch.parallel import mesh
rank, store = int(sys.argv[1]), sys.argv[2]
shape, seed = tuple(json.loads(sys.argv[3])), int(sys.argv[4])
dev = mesh.init_distributed("gloo", store, rank, 2, "cuda")
m = mesh.create_mesh(pipe=2, device=dev)
g = torch.Generator(device=dev).manual_seed(seed)
x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
times = []
for i in range(%d + 1):
    mesh.barrier(m)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    t0 = time.perf_counter()
    start.record()
    if rank == 0:
        mesh.send_stage(x, m, 1)
    else:
        y = mesh.recv_stage(shape, torch.bfloat16, m, 0)
    end.record()
    end.synchronize()
    if i:
        times.append([start.elapsed_time(end),
                      (time.perf_counter() - t0) * 1e3])
if rank == 1:
    assert torch.equal(y, x)
print("MOVE_MS " + json.dumps(times), flush=True)
torch.distributed.destroy_process_group()
print("WORKER OK", flush=True)
""" % MOVE_ITERS


def pipeline_want(steps, microbatches, eval_rows=(), joint=False):
    """One pipe rank's launches over ``steps`` train steps and the eval
    batches of ``eval_rows`` rows: each of its DEPTH / PP_STAGES blocks
    runs once a microbatch (an eval batch of fewer rows than microbatches
    runs fewer); a divided block 2 B1 (packed temporal, dense spatial) and
    1 B2, a joint one 1 B1 (long) and 1 B2, and the backward B3 and B4
    alike. (kernel counts, B1's variants, B3's variants)."""
    per = DEPTH // PP_STAGES
    fwd = (steps * microbatches
           + sum(min(r, microbatches) for r in eval_rows)) * per
    bwd = steps * microbatches * per
    attn = 1 if joint else 2
    by = (lambda n: variants(long=n)) if joint else \
        (lambda n: variants(packed=n, dense=n))
    return ({"fused_prenorm_mhsa": attn * fwd, "fused_prenorm_ffn": fwd,
             "fused_prenorm_mhsa_bwd": attn * bwd,
             "fused_prenorm_ffn_bwd": bwd, "flash_attention": 0,
             "flash_attention_bwd": 0}, by(fwd), by(bwd))


def time_stage_move(tmp, rng, card):
    """A microbatch's activations (MOVE_SHAPE, bf16, normal from a seed of
    ``rng``) from stage 0 to stage 1 over gloo, two ranks on this card,
    MOVE_ITERS times: each end's CUDA-event and host ms."""
    store = f"file://{os.path.join(tmp, 'move_store')}"
    seed = str(int(rng.integers(0, 2**31)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", MOVE_RANK, str(r), store,
         json.dumps(MOVE_SHAPE), seed], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = wait_workers(procs)
    times = [json.loads(ln[len("MOVE_MS "):]) for o in outs
             for ln in o.splitlines() if ln.startswith("MOVE_MS ")]
    mb = np.prod(MOVE_SHAPE) * 2 / 1e6
    mean = lambda rows, i: sum(r[i] for r in rows) / len(rows)
    log(f"pipeline stage move of {MOVE_SHAPE} bf16 ({mb:.2f} MB) over gloo, "
        f"two ranks on one card: sender {mean(times[0], 0):.3f} ms of CUDA "
        f"events / {mean(times[0], 1):.3f} ms on its clock, receiver "
        f"{mean(times[1], 0):.3f} / {mean(times[1], 1):.3f} ms (mean of "
        f"{MOVE_ITERS}; gloo stages the bytes through the host, so this is "
        f"no card-to-card rate) on {card}")
    return {"move_mb": mb, "move_ms_sender": times[0],
            "move_ms_receiver": times[1]}


def pp_microbatch_phases(rng):
    """B1-B4 at the pipeline phase's microbatch shapes, against their plain
    versions: TimeSformer-B divided a microbatch of c clips, temporal rows
    (c · 196, 8, 768), spatial (c · 8, 197, 768), the FFN's c · 1569 rows
    (ViViT-B joint's too), forward and backward at c = 4 (M = 2) and 2
    (M = 4), forward at the eval microbatches' 3 and 1; B1 and B3 long at
    ViViT-B joint's (4, 1569, 768). Under "phases", outside the totals."""
    fwd, bwd = [], []
    for c, what in ((TRAIN_CLIPS // 2, "train, M = 2"),
                    (TRAIN_CLIPS // 4, "train, M = 4"),
                    (CROPS, "eval, 3 rows"), (1, "eval, 1 row")):
        cases = [("block-diagonal temporal", (c * PATCHES, FRAMES, D),
                  FRAMES),
                 ("dense spatial", (c * FRAMES, 1 + PATCHES, D), 0),
                 (f"rows, hidden {4 * D}", (c * (1 + PATCHES * FRAMES), D),
                  None)]
        for kernels, rows in ((("fused_prenorm_mhsa", "fused_prenorm_ffn"),
                               fwd),
                              (("fused_prenorm_mhsa_bwd",
                                "fused_prenorm_ffn_bwd"), bwd)):
            if rows is bwd and what.startswith("eval"):
                continue
            rows += [(kernels[bd is None],
                      f"{label} {shape}, pipeline microbatch, {what}",
                      shape, bd, 1e-5, False, 1)
                     for label, shape, bd in cases]
    long_shape = (TRAIN_CLIPS // 2,) + LONG_SHAPE[1:]
    long_label = (f"long joint space-time {long_shape}, pipeline "
                  f"microbatch, ViViT-B joint M = 2")
    fwd.append(("fused_prenorm_mhsa", long_label, long_shape, 0, 1e-5,
                False, 1))
    bwd.append(("fused_prenorm_mhsa_bwd", long_label, long_shape, 0, 1e-5,
                False, 1))
    with torch.inference_mode():
        report = kernel_phases(rng, fwd, SHARD_ITERS)
        report += backward_phases(rng, bwd, SHARD_ITERS)
    for e in report:
        if e["name"].startswith("fused_prenorm_mhsa"):
            want = ("packed" if "temporal" in e["phase"] else
                    "long" if "long" in e["phase"] else "dense")
            assert e["variant"] == want, e
    return report


def pipeline_parallel_phase(card, ref):
    """Pipeline parallelism on the card (its own generator, SEED + 9, for
    the kernel rows' inputs and the moved tensor): B1-B4 first, alone, at
    the microbatches' shapes (pp_microbatch_phases); then, all at once on
    this card over gloo, tools/mp_train_worker.py's TimeSformer-B
    (divided, 8 x 224, 8 clips, the parallel phase's run) over PP = 2 (two
    ranks, M = 2: three steps and the fit epoch) and over PP = 2 at M = 4
    (one step), and ViViT-B joint at 16 x 224 over PP = 2 (one step, B1/B3
    long on microbatches of 4 clips) while this process runs its
    one-process step; each rank's steps held against the one-process run
    (``ref``: the parallel phase's steps and peak) within the train
    phase's bounds, the ranks' lines identical, each rank's launches (its
    stage's blocks, once a microbatch) and attention variants asserted,
    its peak GiB, step ms by CUDA events and the host clock printed; then
    graft_entry's dryrun_multichip(4) on the card, and a stage move timed
    alone. Two ranks share one card: the times are no pipeline speed and
    no bubble. Returns (the workers' launches, the kernel rows)."""
    ref_steps, ref_peak = ref
    rng = np.random.default_rng(SEED + 9)
    report = pp_microbatch_phases(rng)
    gc.collect()
    torch.cuda.empty_cache()
    wants = {"pp2": pipeline_want(PARALLEL_STEPS, 2, PP_EVAL_ROWS),
             "pp2-m4": pipeline_want(1, 4),
             "vivit-joint-pp2": pipeline_want(1, 2, joint=True)}
    pp_flags = ["--pp", str(PP_STAGES)]
    vivit_args = mp_train_worker.parse_args(PP_VIVIT_ARGS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pp_") as tmp:
        runs = {"pp2": spawn_workers(tmp, "pp2", pp_flags),
                "pp2-m4": spawn_workers(
                    tmp, "pp2-m4", pp_flags + ["--pp_microbatch", "4",
                                               *SP_ONE_STEP]),
                "vivit-joint-pp2": spawn_workers(
                    tmp, "vivit-joint-pp2", pp_flags, base=PP_VIVIT_ARGS)}
        vivit_out, _, vivit_tr, vivit_peak = run_in_process(vivit_args)
        del vivit_tr
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            graft_entry.dryrun_multichip(4, device="cuda")
        dryrun = out.getvalue().strip()
        log(f"pipeline dryrun_multichip(4) on {card}, four gloo ranks on one "
            f"card, bf16 at width 128: {dryrun} "
            f"({time.perf_counter() - t0:.1f} s)")
        outs = {what: wait_workers(procs) for what, procs in runs.items()}
        refs = {"pp2": (ref_steps, ref_peak),
                "pp2-m4": (ref_steps[:1], ref_peak),
                "vivit-joint-pp2": (parse_worker(vivit_out)[0], vivit_peak)}
        launches = dict.fromkeys(KERNEL_NAMES, 0)
        numbers = {"dryrun": dryrun}
        for what, worker_outs in outs.items():
            got, _, peaks = check_worker_run(
                what, worker_outs, *refs[what], wants[what], card,
                label="pipeline parallel")
            for n in KERNEL_NAMES:
                launches[n] += got[n]
            ms = [[(s[2], s[3]) for s in parse_worker(o)[0]]
                  for o in worker_outs]
            for rank, rank_ms in enumerate(ms):
                log(f"pipeline parallel {what} rank {rank} steps (host ms, "
                    f"CUDA-event ms): {rank_ms}; peak {peaks[rank]:.3f} GiB "
                    f"(one process {refs[what][1]:.3f} GiB); two ranks "
                    f"sharing the card: no pipeline speed, no bubble")
            numbers[f"{what}_steps_ms"] = ms
            numbers[f"{what}_peak_gib"] = peaks
            numbers[f"{what}_one_process_peak_gib"] = refs[what][1]
        numbers.update(time_stage_move(tmp, rng, card))
    per_boundary = 2 * 2 * np.prod(MOVE_SHAPE) * 2 / 1e6
    log(f"pipeline parallel: each step moves {per_boundary:.1f} MB across "
        f"the stage boundary at M = 2 (2 microbatches of {MOVE_SHAPE} bf16 "
        f"forward, their gradients back)")
    numbers["boundary_mb_per_step_m2"] = per_boundary
    log(f"pipeline parallel numbers: {json.dumps(numbers)}")
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


# ---------------------------------------------------------------- tools

REPO = os.path.dirname(os.path.abspath(__file__))
NOTEBOOK = os.path.join(REPO, "notebook", "VideoTransformer_torch_demo.ipynb")
DEMO_CLIP = os.path.join(visualize_attention.DEMO_DIR, "checker_spin_0.mp4")
ROWS_SUM_TOL = 1e-3  # a bf16 softmax row's sum, as the memory phase holds it
TRACE_SPAN_TOL = 0.1  # the trace's device span against the CUDA events
SERVE_SECONDS = 5
NO_LAUNCHES = dict.fromkeys(KERNEL_NAMES, 0)


def counts_of(**per_call):
    """The launch counts of calls: ``per_call`` maps a kernel name to its
    launches; the rest 0."""
    return {**NO_LAUNCHES, **per_call}


def nonconstant_pngs(paths):
    from PIL import Image

    for path in paths:
        img = np.asarray(Image.open(path))
        assert img.std() > 0, path


def tools_viz_attention(tmp, seed):
    """visualize_attention's run at TimeSformer-B 8x224 on a demo clip (the
    last block's spatial attention plain, the blocks before it and the last
    block's temporal attention through B1/B2), its cls rows against the
    same model's plain fp32 run on the CPU."""
    args = visualize_attention.parse_args([
        "--video", DEMO_CLIP, "--output_dir", os.path.join(tmp, "attn"),
        "--seed", str(seed)])
    reset_counts()
    video, rows = visualize_attention.run(args)
    torch.cuda.synchronize()
    counts = read_counts()
    cpu = visualize_attention.cls_attention(
        visualize_attention.build_model(args).eval(), video)
    err = np.abs(rows - cpu).max()
    sums = np.abs(rows.sum(-1) - 1).max()
    log(f"tools visualize_attention (TimeSformer-B 8x224, bf16): cls rows "
        f"{rows.shape}, summing to 1 within {sums:.3e}, within {err:.3e} of "
        f"the plain fp32 CPU run (tol {ATTENTION_WEIGHTS_TOL}); launches "
        f"{counts}")
    assert rows.shape == (FRAMES, HEADS, 1 + (IMG // 16) ** 2), rows.shape
    assert np.isfinite(rows).all()
    assert sums <= ROWS_SUM_TOL, sums
    assert err <= ATTENTION_WEIGHTS_TOL, err
    assert counts == counts_of(fused_prenorm_mhsa=2 * DEPTH - 1,
                               fused_prenorm_ffn=DEPTH - 1), counts
    nonconstant_pngs(os.path.join(args.output_dir, f"attn_img{i}.png")
                     for i in range(FRAMES))
    return counts


def tools_viz_maskfeat(tmp, seed):
    """visualize_maskfeat's run at MViT-B 16x224 through the kernels, and
    again through the plain versions, both with cuDNN's deterministic
    algorithms: the HOG maps within MIM_FEATURE_REL_TOL."""
    args = visualize_maskfeat.parse_args([
        "--output_dir", os.path.join(tmp, "maskfeat"), "--seed", str(seed)])
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        reset_counts()
        got = visualize_maskfeat.run(args)
        torch.cuda.synchronize()
        counts = read_counts()
        want = with_plain_versions(visualize_maskfeat.run, args)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    rel = worst_error([torch.from_numpy(got["hog_preds"])],
                      [torch.from_numpy(want["hog_preds"])])[1]
    log(f"tools visualize_maskfeat (MViT-B 16x224, bf16): hog_preds "
        f"{got['hog_preds'].shape}, loss {float(got['loss']):.5f} (plain "
        f"{float(want['loss']):.5f}), max|kernel-plain|/max|plain| "
        f"{rel:.3e} (tol {MIM_FEATURE_REL_TOL}); launches {counts}")
    assert np.isfinite(got["hog_preds"]).all()
    assert rel <= MIM_FEATURE_REL_TOL, rel
    assert counts == counts_of(fused_prenorm_ffn=MIM_WANT["fused_prenorm_ffn"],
                               flash_attention=MIM_WANT["flash_attention"]), \
        counts
    nonconstant_pngs(os.path.join(args.output_dir, n)
                     for n in ("hog_pred.png", "real_img.png",
                               "mask_img.png"))
    return counts


def tools_trace_step(tmp, card):
    """trace_step's finetune (3 traced steps) and maskfeat (1) configs: the
    categories sum to the device total, the port's kernels are in it, and
    the trace's device span is within TRACE_SPAN_TOL of the CUDA events
    around the traced steps (a host-held step's device total is below its
    CUDA-event time by the idle share: both are printed)."""
    launches = dict(NO_LAUNCHES)
    for config, steps, per_step in (
            ("finetune", 3, counts_of(
                fused_prenorm_mhsa=2 * DEPTH, fused_prenorm_ffn=DEPTH,
                fused_prenorm_mhsa_bwd=2 * DEPTH,
                fused_prenorm_ffn_bwd=DEPTH)),
            ("maskfeat", 1, MIM_WANT)):
        gc.collect()
        reset_counts()
        out = trace_step.run(trace_step.parse_args([
            "--config", config, "--steps", str(steps), "--trace_dir",
            os.path.join(tmp, f"trace_{config}")]))
        counts = read_counts()
        a = out["analysis"]
        assert a is not None, f"trace_step {config}: no device events"
        cats, total = a["categories"], a["device_ms"]
        events = out["event_ms_per_step"]
        log(f"tools trace_step {config} on {card}: wall "
            f"{out['wall_ms_per_step']:.3f} ms a step, CUDA events "
            f"{events:.3f}, trace span {a['span_ms']:.3f} (ratio "
            f"{a['span_ms'] / events:.4f}, tol {TRACE_SPAN_TOL}), device "
            f"total {total:.3f} (ratio {total / events:.4f}), busy "
            f"{a['busy_ms']:.3f}, host share {out['host_share']:.4f}; "
            f"launches {counts}")
        assert abs(sum(cats.values()) - total) <= 1e-9 * total, cats
        assert cats["port"] > 0, cats
        assert abs(a["span_ms"] - events) <= TRACE_SPAN_TOL * events, \
            (a["span_ms"], events)
        # the 2 steps before the trace and the traced ones
        assert counts == {n: (2 + steps) * c for n, c in per_step.items()}, \
            counts
        for n in KERNEL_NAMES:
            launches[n] += counts[n]
    return launches


def tools_trace_infer(tmp):
    """trace_infer on both archs, batches of 8: TimeSformer-B a rep of
    warm-up and 3 traced reps of 4 batches (its defaults), MViT-B one and
    one of 2 (its trace holds cuDNN's many launches)."""
    launches = dict(NO_LAUNCHES)
    for arch, reps, scans, per_forward in (
            ("timesformer", 3, 4, counts_of(fused_prenorm_mhsa=2 * DEPTH,
                                            fused_prenorm_ffn=DEPTH)),
            ("mvit", 1, 2, counts_of(
                fused_prenorm_ffn=MIM_WANT["fused_prenorm_ffn"],
                flash_attention=MIM_WANT["flash_attention"]))):
        reset_counts()
        out = trace_infer.run(trace_infer.parse_args([
            "--arch", arch, "--reps", str(reps), "--scans", str(scans),
            "--trace_dir", os.path.join(tmp, f"trace_infer_{arch}")]))
        counts = read_counts()
        assert out["analysis"] is not None, f"trace_infer {arch}: no events"
        assert out["analysis"]["categories"]["port"] > 0
        assert counts == {n: (1 + reps) * scans * c
                          for n, c in per_forward.items()}, counts
        for n in KERNEL_NAMES:
            launches[n] += counts[n]
    return launches


def tools_profile_train():
    """profile_train: 7 calls (2 + 5) of each timed piece; the forwards
    and fwd+bwd through B1/B2 (and B3/B4), the step through all four."""
    reset_counts()
    line = profile_train.run(profile_train.parse_args([]))
    counts = read_counts()
    forwards, backwards = 7 * 3 + 1 + 7, 7 + 1 + 7  # fwd x2, fwd+bwd, opt
    assert counts == counts_of(
        fused_prenorm_mhsa=forwards * 2 * DEPTH,
        fused_prenorm_ffn=forwards * DEPTH,
        fused_prenorm_mhsa_bwd=backwards * 2 * DEPTH,
        fused_prenorm_ffn_bwd=backwards * DEPTH), counts
    assert line["timer"] == "cuda_events"
    return counts


def tools_serve_bench(card):
    """serve_bench for SERVE_SECONDS: every answer within SERVER_REL_TOL of
    the predictor's direct answer for the clip."""
    reset_counts()
    lines, clip, answers, predictor = serve_bench.run(serve_bench.parse_args(
        ["--seconds", str(SERVE_SECONDS)]))
    counts = read_counts()
    direct = predictor(clip[None])[0]
    scale = np.abs(direct).max()
    worst = max(np.abs(a - direct).max() for a in answers) / scale
    hist = {int(k): v for k, v in lines[-1]["batch_histogram"].items()}
    log(f"tools serve_bench on {card}: {len(answers)} answers, batches "
        f"{hist}, worst rel diff from the direct answer {worst:.3e} (tol "
        f"{SERVER_REL_TOL})")
    assert worst <= SERVER_REL_TOL, worst
    assert max(hist) > 1, hist
    assert counts["fused_prenorm_mhsa"] > 0 and \
        counts["fused_prenorm_ffn"] > 0, counts
    return counts


def tools_run_all():
    """run_all's full matrix; every kernel launched in it."""
    reset_counts()
    t0 = time.perf_counter()
    lines = run_all.run(run_all.parse_args([]))
    counts = read_counts()
    log(f"tools run_all: {len(lines)} lines in "
        f"{time.perf_counter() - t0:.1f} s; launches {counts}")
    assert not [ln for ln in lines if "error" in ln], lines
    assert all(counts[n] > 0 for n in KERNEL_NAMES), counts
    return counts


def tools_notebook():
    """The port notebook's code cells in order, with ``exec`` (this machine
    need not have nbclient), the parameters cell as it is (the card,
    TimeSformer-B) but for the checkout's root."""
    with open(NOTEBOOK) as f:
        cells = ["".join(c["source"]) for c in json.load(f)["cells"]
                 if c["cell_type"] == "code"]
    scope, out = {}, io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        for i, source in enumerate(cells):
            exec(compile(source, f"{NOTEBOOK} code cell {i}", "exec"), scope)
            if i == 0:
                scope["repo_root"] = REPO
    torch.cuda.synchronize()
    counts = read_counts()
    printed = out.getvalue()
    log(f"tools notebook: {printed.strip().splitlines()[-1]}; launches "
        f"{counts}")
    assert "prediction:" in printed, printed
    assert scope["logits"].shape == (1, CLASSES)
    assert torch.isfinite(scope["logits"]).all()
    assert counts == counts_of(fused_prenorm_mhsa=2 * DEPTH,
                               fused_prenorm_ffn=DEPTH), counts
    return counts


def tools_phase(card):
    """The tools and the measuring twins, each with the launch counts from 0
    and asserted. The visualisation tools' seeds (their temporal windows and
    the cube mask) come from a generator of the phase's own, SEED + 7; the
    twins seed their own draws. Returns the launches summed over them and
    each part's seconds."""
    rng = np.random.default_rng(SEED + 7)
    seeds = rng.integers(0, 2**31, 2)
    launches, seconds = dict(NO_LAUNCHES), {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        parts = [("visualize_attention",
                  lambda: tools_viz_attention(tmp, seeds[0])),
                 ("visualize_maskfeat",
                  lambda: tools_viz_maskfeat(tmp, seeds[1])),
                 ("trace_step", lambda: tools_trace_step(tmp, card)),
                 ("trace_infer", lambda: tools_trace_infer(tmp)),
                 ("profile_train", tools_profile_train),
                 ("serve_bench", lambda: tools_serve_bench(card)),
                 ("run_all", tools_run_all),
                 ("notebook", tools_notebook)]
        for name, part in parts:
            t0 = time.perf_counter()
            for n, c in part().items():
                launches[n] += c
            gc.collect()
            torch.cuda.empty_cache()
            seconds[name] = time.perf_counter() - t0
            log(f"tools {name}: {seconds[name]:.1f} s")
    return launches, seconds


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
    # the 16-frame joint shape from the long generator (its draws come
    # before the ViViT phases'), the other hd-64 shapes from one of their own
    (joint, joint_where), *others = LONG_SHAPES
    report += flash_phases(long_rng, [((*joint[:3], 0), JOINT_HD,
                                       joint_where)])
    report += flash_phases(np.random.default_rng(SEED + 10), [
        ((*shape[:3], 0), JOINT_HD, where) for shape, where in others])
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
    joint_forms_phase(np.random.default_rng(SEED + 12))
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

    # ---- MViT's pools at the benchmark's batch, each block's alone (its own
    # generator: the other paths' draws stay those of the runs before it)
    pool_report = mvit_pool_phase(np.random.default_rng(SEED + 11), card)
    t0 = lap("mvit pools", t0)

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
    par_launches, par_report, par_ref = parallel_phase(card)
    report += par_report
    t0 = lap("parallel", t0)
    torch.cuda.empty_cache()

    # ---- sequence parallelism: each worker's counts from its start
    # (sequence_parallel_phase)
    sp_launches, sp_report = sequence_parallel_phase(card, par_ref)
    report += sp_report
    t0 = lap("sequence parallel", t0)
    torch.cuda.empty_cache()

    # ---- pipeline parallelism: each worker's counts from its start
    # (pipeline_parallel_phase)
    pp_launches, pp_report = pipeline_parallel_phase(card, par_ref)
    report += pp_report
    t0 = lap("pipeline parallel", t0)
    torch.cuda.empty_cache()

    # ---- the memory levers: counts from 0 before each step and before the
    # attention-weights forward (memory_phase)
    mem_launches, mem_recomputed, mem_report = memory_phase(card)
    report += mem_report
    t0 = lap("memory", t0)
    torch.cuda.empty_cache()

    # ---- the tools, the notebook and the measuring twins: counts from 0
    # before each (tools_phase)
    tools_launches, seconds["tools parts"] = tools_phase(card)
    t0 = lap("tools", t0)

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
                   "sequence_parallel": sp_launches[name],
                   "pipeline_parallel": pp_launches[name],
                   "memory": mem_launches[name],
                   "tools": tools_launches[name]}
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
    # MViT's pools: a port-only kernel (no TPU kernel), its times those of
    # a MaskFeat step's 16 calls at POOL_CLIPS clips
    kernels.append({**pool_report,
                    "launches_per_mim_step": dict(zip(
                        ("forward", "backward"), MIM_POOL_WANT))})
    log(f"data path numbers: {json.dumps(data_numbers)}")
    log(f"phase seconds: {json.dumps(seconds)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
