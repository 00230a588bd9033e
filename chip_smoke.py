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
- mim: three MaskFeat pretraining steps on MViT-B (16x224, 16 blocks, two
  q-pool stages, masks from the cube mask generator, HOG targets computed on
  the card from the raw clip) on 8 clips with cuDNN's deterministic
  algorithms, timed, and repeated from the same state through the plain
  versions, compared, and profiled; further steps with cuDNN's default
  algorithms, timed and profiled; then one supervised arch=mvit step (layer decay 0.75,
  decoder_pred frozen) and an eval-mode forward on 2 clips against the plain
  versions.

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
wrapper's and scaled_dot_product_attention's). The last line is
{"ok": true, "device": {...}}. Its phases took 179-196 s on an H100 (the
six builds included). B3's backward phases also time its whole call (with
the projection products) beside its bound. Before the serving path it
prints B1's, B2's, B3's and B4's stages (device ms a call) beside
torch.matmul at each product's shape, and B2's fc1 with and without its
GELU epilogue.
"""

import gc
import json
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

from videotransformer_tpu_torch.data.mask_generator import (
    CubeMaskGenerator, pad_cube_marker)
from videotransformer_tpu_torch.data.transforms import eval_transform_clip
from videotransformer_tpu_torch.kernels import (
    _build, flash_attention, fused_ffn, fused_mhsa)
from videotransformer_tpu_torch.models import convert, mvit
from videotransformer_tpu_torch.models.convert import split_artifact_params
from videotransformer_tpu_torch.models.timesformer import (
    get_vit_base_patch16_224)
from videotransformer_tpu_torch.ops.blocks import ClassificationHead
from videotransformer_tpu_torch.serving.predictor import (
    TorchPredictor, make_predict_fn)
from videotransformer_tpu_torch.serving.server import InferenceServer
from videotransformer_tpu_torch.tools.flash_bench import (
    FLASH_SHAPES, HD as MVIT_HD, bound, flash_bounds, issue_us, sdpa_times,
    timed_ms)
from videotransformer_tpu_torch.tools.fused_bench import (
    FFN_FWD_PRODUCTS, FFN_PRODUCTS, MHSA_BWD_PRODUCTS, MHSA_PRODUCTS,
    fc1_epilogue_ms, ffn_fwd_case, ffn_fwd_products,
    ffn_products, format_stages, matmul_ms, mhsa_bwd_bound, mhsa_bwd_case,
    mhsa_bwd_products, mhsa_products, stage_times)
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

def ffn_weights(rng, d):
    """LayerNorm weight and bias, fc1 weight and bias, fc2 weight and bias
    of a width-d FFN (hidden 4·d), bf16 on the card."""
    h4 = 4 * d
    return [bf16_on_card(rng, (d,), 0.1, 1.0), bf16_on_card(rng, (d,), 0.1),
            bf16_on_card(rng, (h4, d), 0.02), bf16_on_card(rng, (h4,), 0.02),
            bf16_on_card(rng, (d, h4), 0.02), bf16_on_card(rng, (d,), 0.02)]


def kernel_phases(rng):
    """Each forward kernel at a main-path shape against its plain version
    run in fp32 from the same bf16 inputs; times in turns (plain, kernel,
    kernel, plain) from CUDA events."""
    # (kernel, phase, shape, block_diag, LayerNorm eps, on the TimeSformer
    # path once per block, calls a mim step); the packed layout is the JAX
    # package's
    phases = [
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
    for name, label, shape, block_diag, eps, on_path, count in phases:
        d = shape[-1]
        x = bf16_on_card(rng, shape, 1.0)
        if block_diag is not None:
            ln = [bf16_on_card(rng, (d,), 0.1, 1.0), bf16_on_card(rng, (d,), 0.1)]
            w = [bf16_on_card(rng, (3 * d, d), 0.02),
                 bf16_on_card(rng, (3 * d,), 0.02),
                 bf16_on_card(rng, (d, d), 0.02), bf16_on_card(rng, (d,), 0.02)]
            tail = (HEADS, (d // HEADS) ** -0.5, eps, False, block_diag)
            kernel = lambda: fused_mhsa.fused_prenorm_mhsa(x, *ln, *w, *tail)
            plain_fn = fused_mhsa.fused_prenorm_mhsa_reference
        else:
            wts = ffn_weights(rng, d)
            ln, w = wts[:2], wts[2:]
            tail = (eps,)
            kernel = lambda: fused_ffn.fused_prenorm_ffn(x, *ln, *w, *tail)
            plain_fn = fused_ffn.fused_prenorm_ffn_reference
        got = kernel()
        torch.cuda.synchronize()
        abs_err, rel_err = worst_error(
            [got], [plain_fn(*[t.float() for t in (x, *ln, *w)], *tail)])
        assert rel_err <= KERNEL_REL_TOL, (label, rel_err)
        # the plain version as the main path would call it: bf16 operands
        ms, plain_ms = in_turns(lambda: plain_fn(x, *ln, *w, *tail), kernel,
                                plain_iters=20)
        rows = shape[0] * shape[1] if len(shape) == 3 else shape[0]
        if block_diag is not None:  # qkv, attention over L, proj
            L = block_diag or shape[1]
            flops = 8 * rows * d * d + 4 * rows * L * d
            nbytes = 2 * (2 * rows * d + 4 * d * d + 6 * d)
        else:
            flops = 16 * rows * d * d
            nbytes = 2 * (2 * rows * d + 8 * d * d + 7 * d)
        bound_ms, bound_by = bound(flops, nbytes)
        log(f"kernel {name} [{label}]: max|kernel-plain|/max|plain| = "
            f"{rel_err:.3e} (tol {KERNEL_REL_TOL}), max abs {abs_err:.3e}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        report.append({"name": name, "phase": label, "on_path": on_path,
                       "count": count, "max_abs_err": abs_err,
                       "rel_err": rel_err, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": None, "bound_ms": bound_ms,
                       "bound_by": bound_by})
        del x, w, got
    return report


def backward_phases(rng):
    """Each backward kernel at a train-step shape (batch of 8 clips) against
    its plain backward run in fp32 from the same bf16 inputs: every output
    gradient within KERNEL_REL_TOL of max|plain| of that gradient, and the
    same bits twice. Times in turns (plain, kernel, kernel, plain): B3 alone
    (``_attn_bwd_launch`` against ``_attn_bwd_reference``: the attention
    backward, d_xn, the LayerNorm backward and the sums, as timed since B3's
    first port) and B3's whole call (``_launch_backward``, with dw_proj, do
    and dw_qkv, against ``fused_prenorm_mhsa_backward_reference``), each
    beside its bound; B4 whole."""
    phases = [
        ("fused_prenorm_mhsa_bwd", "dense spatial (64, 197, 768)",
         (64, 197, D), 0, 1e-5, True, 1),
        ("fused_prenorm_mhsa_bwd", "block-diagonal temporal (1568, 8, 768)",
         (1568, 8, D), 8, 1e-5, True, 1),
        ("fused_prenorm_ffn_bwd", f"rows (12552, {D}), hidden {4 * D}",
         (12552, D), None, 1e-5, True, 1),
    ] + [("fused_prenorm_ffn_bwd", label, shape, None, eps, on_path, n)
         for label, shape, eps, on_path, n in MVIT_FFN_PHASES]
    report = []
    for name, label, shape, block_diag, eps, on_path, count in phases:
        d = shape[-1]
        x = bf16_on_card(rng, shape, 1.0)
        g = bf16_on_card(rng, shape, 1.0)
        if block_diag is not None:
            ln = [bf16_on_card(rng, (d,), 0.1, 1.0), bf16_on_card(rng, (d,), 0.1)]
            w = [bf16_on_card(rng, (3 * d, d), 0.02),
                 bf16_on_card(rng, (3 * d,), 0.02),
                 bf16_on_card(rng, (d, d), 0.02), bf16_on_card(rng, (d,), 0.02)]
            cfg = (HEADS, (d // HEADS) ** -0.5, eps, False, block_diag)
            _, qkv, attn = fused_mhsa._launch(x, *ln, *w, *cfg)
            args = (g, x, qkv, attn, ln[0], ln[1], w[0], w[2])
            kernel_all = lambda: fused_mhsa._launch_backward(*args, *cfg)
            plain_all = fused_mhsa.fused_prenorm_mhsa_backward_reference
            do = (g.float().reshape(-1, d) @ w[2].float()).to(torch.bfloat16)
            core = (x, qkv, do, None, ln[0], w[0], *cfg[:3], block_diag)
            kernel = lambda: fused_mhsa._attn_bwd_launch(*core)
            plain = lambda: fused_mhsa._attn_bwd_reference(*core)
            tail = cfg
        else:
            w = ffn_weights(rng, d)
            _, h_pre = fused_ffn._launch(x, *w, eps, True)
            args = (g, x, h_pre, w[0], w[1], w[2], w[4])
            tail = (eps,)
            kernel_all = kernel = lambda: fused_ffn._launch_backward(*args,
                                                                   *tail)
            plain_all = fused_ffn.fused_prenorm_ffn_backward_reference
            plain = lambda: plain_all(*args, *tail)
        got = kernel_all()
        torch.cuda.synchronize()
        abs_err, rel_err = worst_error(
            got, plain_all(*[a.float() for a in args], *tail))
        assert rel_err <= KERNEL_REL_TOL, (label, rel_err)
        # no atomics: B3's and B4's split sums give the same bits twice
        assert all(torch.equal(a, b) for a, b in zip(got, kernel_all()))
        ms, plain_ms = in_turns(plain, kernel)
        rows = shape[0] * shape[1] if len(shape) == 3 else shape[0]
        entry = {"name": name, "phase": label, "on_path": on_path,
                 "count": count, "max_abs_err": abs_err, "rel_err": rel_err,
                 "ms": ms, "plain_ms": plain_ms, "library_ms": None}
        if block_diag is not None:
            L = block_diag or shape[1]
            core_got = kernel()
            torch.cuda.synchronize()
            core_err = worst_error(core_got, fused_mhsa._attn_bwd_reference(
                *[a.float() if torch.is_tensor(a) else a for a in core]))
            assert core_err[1] <= KERNEL_REL_TOL, (label, core_err)
            assert all(torch.equal(a, b) for a, b in zip(core_got, kernel()))
            bound_ms, bound_by = mhsa_bwd_bound(rows, L, d, whole=False)
            whole_ms, whole_plain = in_turns(lambda: plain_all(*args, *tail),
                                             kernel_all)
            whole_bound, whole_by = mhsa_bwd_bound(rows, L, d)
            entry.update(whole_ms=whole_ms, whole_plain_ms=whole_plain,
                         whole_bound_ms=whole_bound, whole_bound_by=whole_by)
            whole = (f"; whole backward call {whole_ms:.4f} ms, plain "
                     f"{whole_plain:.4f} ms, bound {whole_bound:.4f} ms "
                     f"({whole_by}); B3 alone against its plain version "
                     f"{core_err[1]:.3e}")
        else:
            bound_ms, bound_by = bound(
                32 * rows * d * d,  # B4: four products, fp32 weight grads
                2 * (7 * rows * d + 8 * d * d) + 4 * 8 * d * d)
            whole = ""
        entry.update(bound_ms=bound_ms, bound_by=bound_by)
        log(f"kernel {name} [{label}]: worst max|kernel-plain|/max|plain| "
            f"over the gradients = {rel_err:.3e} (tol {KERNEL_REL_TOL}), "
            f"max abs {abs_err:.3e}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
            + whole)
        report.append(entry)
        del x, g, w, got
    return report


def stage_phases(rng):
    """B1 at the serving shapes, B2 at the serving shape and one MViT width,
    B3's whole call at both train shapes and B4 at the TimeSformer train
    shape, stage by stage (device ms a call, torch.profiler), with
    torch.matmul's device ms at each product's GEMM shape beside them (a
    yardstick the port never calls), and B2's fc1 with and without its GELU
    epilogue; tools/fused_bench.py prints the same for every shape and
    against another checkout's kernels."""
    cases = [("fused_prenorm_mhsa", "dense spatial (192, 197, 768)",
              (192, 197, D), 0),
             ("fused_prenorm_mhsa", "block-diagonal temporal (4704, 8, 768)",
              (4704, 8, D), 8),
             ("fused_prenorm_ffn", f"rows (37656, {D}), hidden {4 * D}",
              (37656, D), 1e-5),
             ("fused_prenorm_ffn", "MViT rows (12544, 384), hidden 1536",
              (12544, 384), 1e-6),
             ("fused_prenorm_mhsa_bwd", "dense spatial (64, 197, 768)",
              (64, 197, D), 0),
             ("fused_prenorm_mhsa_bwd",
              "block-diagonal temporal (1568, 8, 768)", (1568, 8, D), 8),
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
            args, cfg, _ = mhsa_bwd_case(rng, shape, extra)
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
        yard = matmul_ms(pairs)
        log(f"stages {name} [{label}] (device ms a call): "
            f"{format_stages(stage_times(fn, products))}; torch.matmul at "
            f"the products' GEMM shapes: " + ", ".join(
                f"{p} {t:.4f}" for p, t in zip(products, yard)) + note)
        del args, pairs


def flash_phases(rng):
    """B5 and B6 at each (B·H, Nq, Nkv) of a batch-8 mim step, head dim 96:
    each against its plain version run in fp32 from the same bf16 inputs
    (B6 from the kernel's own o and lse, every gradient); times in turns
    (plain, kernel, kernel, plain), and scaled_dot_product_attention's as
    the library's (the backward's: its forward and backward less its
    forward); the host time to issue a call, the wrapper's and the
    library's."""
    report = []
    scale = MVIT_HD ** -0.5
    for bh, nq, nkv, count in FLASH_SHAPES:
        label = f"(B·H, Nq, Nkv) = ({bh}, {nq}, {nkv}), hd {MVIT_HD}, " \
            f"x{count} a step"
        q = bf16_on_card(rng, (1, bh, nq, MVIT_HD), 1.0)
        k = bf16_on_card(rng, (1, bh, nkv, MVIT_HD), 1.0)
        v = bf16_on_card(rng, (1, bh, nkv, MVIT_HD), 1.0)
        do = bf16_on_card(rng, (1, bh, nq, MVIT_HD), 1.0)
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
        fwd_bound, bwd_bound, flops = flash_bounds(bh, nq, nkv, MVIT_HD)
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
    ``ranges`` the device time of the kernels launched inside it."""
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
TIMESFORMER_ATTENTION = {"packed": DEPTH, "dense": DEPTH, "general": 0}


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
                      "attention": dict(fused_mhsa.ATTENTION_LAUNCHES),
                      "attention_bwd": dict(fused_mhsa.ATTENTION_BWD_LAUNCHES),
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
                              fused_ffn.fused_prenorm_ffn_backward_reference),
            mock.patch.object(flash_attention, "_launch",
                              flash_attention._forward_reference),
            mock.patch.object(
                flash_attention, "_launch_backward",
                flash_attention.flash_attention_backward_reference)]


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
        assert k["attention"] == TIMESFORMER_ATTENTION, (i, k["attention"])
        assert k["attention_bwd"] == TIMESFORMER_ATTENTION, \
            (i, k["attention_bwd"])
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
    t0 = time.perf_counter()
    report = flash_phases(rng)  # autograd on (the library's backward)
    with torch.inference_mode():
        report += kernel_phases(rng) + backward_phases(rng)
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
    del predictor
    t0 = lap("serve", t0)

    # ---- the training path: counts from 0 before each step (train_slice)
    train_launches = train_slice(rng, card)
    t0 = lap("train", t0)
    torch.cuda.empty_cache()

    # ---- the mim path: counts from 0 before each step (mim_slice), then
    # the supervised MViT step (counts from 0 before it)
    mim_launches, mim_trainer, mim_data = mim_slice(rng, card)
    t0 = lap("mim", t0)
    mim_forward_check(mim_trainer, mim_data)
    del mim_trainer, mim_data
    torch.cuda.empty_cache()
    mvit_launches = mvit_supervised_step(rng)
    t0 = lap("mvit supervised step and mim forward check", t0)

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
                       "name", "on_path", "tflops", "issue_us",
                       "library_issue_us")}
                  for e in report if e["name"] == name]
        # the on-path phases, each weighted by its calls: one TimeSformer
        # block, or one mim step for the flash attention kernels
        on_path = [e for e in report if e["name"] == name and e["on_path"]]
        total = lambda key: sum(e["count"] * e[key] for e in on_path)
        library = [e["library_ms"] for e in on_path]
        by_path = {"serve": serve_launches[name],
                   "train": train_launches[name], "mim": mim_launches[name],
                   "mvit": mvit_launches[name]}
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
    log(f"phase seconds: {json.dumps(seconds)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
