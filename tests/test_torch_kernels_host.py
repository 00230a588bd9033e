"""Host-side logic of the fused kernels' wrappers, on the CPU: the row slices
of B4's and B3's split weight gradients, the choice of B1's and B3's
attention kernels, B3's refusals, B1's output with a gradient wanted and
without, and B6's query splits, row arrays and scratch."""

import numpy as np
import pytest
import torch

from videotransformer_tpu_torch.kernels import (
    flash_attention, fused_ffn, fused_mhsa)

# (M, N, K): B4's weight gradients dW2 (Do, hidden) and dW1 (hidden, D),
# K = rows, at MViT-B's and TimeSformer-B's widths, and ragged row counts
WGRAD_SHAPES = [(192, 768, 50176), (768, 192, 50176), (384, 1536, 12544),
                (1536, 384, 12544), (768, 3072, 12544), (3072, 768, 12552),
                (64, 256, 150), (64, 256, 8), (384, 1536, 1003),
                (3072, 768, 1000)]


@pytest.mark.parametrize("M,N,K", WGRAD_SHAPES)
def test_split_k_covers_every_row_once(M, N, K):
    slices, per = fused_ffn.split_k(M, N, K)
    ktiles = -(-K // fused_ffn.K_TILE)
    starts = [z * per for z in range(slices)]
    ends = [min(ktiles, s + per) for s in starts]
    assert 1 <= slices <= fused_ffn.MAX_SLICES
    assert starts[0] == 0 and ends[-1] == ktiles
    assert all(e > s for s, e in zip(starts, ends))  # no empty slice
    assert all(e == s for e, s in zip(ends, starts[1:]))  # no gap, no overlap
    covered = np.zeros(ktiles, int)
    for s, e in zip(starts, ends):
        covered[s:e] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("M,N,K", WGRAD_SHAPES)
def test_split_k_depends_on_the_shape_alone(M, N, K):
    """The same shape gives the same slices (so the same order of sums, the
    same bits) on every call; the blocks cover an H100's 132 SMs twice
    wherever the rows allow slices of MIN_SLICE_KTILES k tiles."""
    slices, per = fused_ffn.split_k(M, N, K)
    assert fused_ffn.split_k(M, N, K) == (slices, per)
    tiles = -(-M // fused_ffn.WGRAD_TILE) * -(-N // fused_ffn.WGRAD_TILE)
    ktiles = -(-K // fused_ffn.K_TILE)
    if ktiles // fused_ffn.MIN_SLICE_KTILES * tiles >= \
            fused_ffn.SPLIT_K_BLOCKS and \
            -(-fused_ffn.SPLIT_K_BLOCKS // tiles) <= fused_ffn.MAX_SLICES:
        assert tiles * slices >= fused_ffn.SPLIT_K_BLOCKS
    assert per >= min(ktiles, fused_ffn.MIN_SLICE_KTILES)


def test_split_k_at_mvit_widths():
    """MViT-B's narrow widths get enough slices to fill the card; TimeSformer-
    B's (3072 x 768, 144 tiles) gets two."""
    assert fused_ffn.split_k(192, 768, 50176)[0] == 22
    assert fused_ffn.split_k(1536, 384, 12544)[0] == 8
    assert fused_ffn.split_k(768, 3072, 12552)[0] == 2


@pytest.mark.parametrize("L,hd,variant", [
    (197, 64, "dense"),      # divided spatial, TimeSformer-B
    (8, 64, "packed"),       # divided temporal (and the packed 896 layout)
    (16, 64, "packed"),
    (100, 64, "dense"),
    (256, 64, "dense"),
    (257, 64, "long"),       # too long for the whole row in registers
    (1569, 64, "long"),      # joint space-time, 8 (effective) frames
    (3137, 64, "long"),
    (9, 64, "dense"),        # cls + 8: does not divide the 64-row tile
    (197, 96, "general"),    # head dim off the tensor-core kernels
    (8, 16, "general"),
    (300, 32, "general"),
])
def test_attention_variant(L, hd, variant):
    assert fused_mhsa.attention_variant(L, hd) == variant


def _mhsa_args(rng, B, N, D):
    mk = lambda *s, std=0.05, mean=0.0: torch.from_numpy(
        rng.standard_normal(s, dtype=np.float32) * std + mean)
    return [mk(B, N, D, std=1.0), mk(D, mean=1.0), mk(D), mk(3 * D, D),
            mk(3 * D), mk(D, D), mk(D)]


@pytest.mark.parametrize("B,N,block_diag", [(2, 17, 0), (3, 16, 8),
                                            (2, 24, 8), (1, 9, 0)])
def test_mhsa_modes_give_the_same_output(B, N, block_diag):
    """With a gradient wanted (a graph recorded, qkv and attn kept for the
    backward), under inference_mode and under no_grad the output is the
    same."""
    args = _mhsa_args(np.random.default_rng(N + B), B, N, 32)
    tail = (4, 8 ** -0.5, 1e-5, True, block_diag)
    x = args[0].clone().requires_grad_()
    trained = fused_mhsa.fused_prenorm_mhsa(x, *args[1:], *tail)
    with torch.inference_mode():
        served = fused_mhsa.fused_prenorm_mhsa(*args, *tail)
    with torch.no_grad():
        quiet = fused_mhsa.fused_prenorm_mhsa(x, *args[1:], *tail)
    assert trained.grad_fn is not None and quiet.grad_fn is None
    assert torch.equal(trained.detach(), served)
    assert torch.equal(quiet, served)
    trained.square().sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


@pytest.mark.parametrize("L,hd,variant", [
    (197, 64, "dense"),      # divided spatial, TimeSformer-B
    (65, 64, "dense"),
    (256, 64, "dense"),
    (33, 64, "dense"),
    (8, 64, "packed"),       # divided temporal
    (32, 64, "packed"),
    (64, 64, "packed"),
    (9, 64, "general"),      # cls + 8: the CUDA-core kernel
    (257, 64, "long"),
    (1569, 64, "long"),      # joint space-time, 8 (effective) frames
    (197, 16, "general"),
    (300, 32, "general"),
    (8, 96, "general"),
])
def test_attention_bwd_variant(L, hd, variant):
    assert fused_mhsa.attention_bwd_variant(L, hd) == variant


# (rows, D, Da, Do, heads, L): B3 at the TimeSformer train shapes (dense and
# temporal), at Da != D, and small and ragged row counts
PLAN_SHAPES = [(12608, 768, 768, 768, 12, 197), (12544, 768, 768, 768, 12, 8),
               (591, 256, 128, 256, 2, 197), (296, 768, 384, 768, 6, 8),
               (130, 64, 64, 64, 1, 65), (8, 64, 64, 64, 1, 8)]


@pytest.mark.parametrize("rows,D,Da,Do,H,L", PLAN_SHAPES)
def test_backward_plan_splits_cover_every_row_once(rows, D, Da, Do, H, L):
    """dw_proj (Do, Da) and dw_qkv (3Da, D) are summed over the rows in
    fused_ffn.split_k's slices: from the shape alone, every row in one
    slice, none empty."""
    plan = fused_mhsa.backward_plan(rows, D, Da, Do, H, L)
    assert plan == fused_mhsa.backward_plan(rows, D, Da, Do, H, L)
    assert plan.variant == fused_mhsa.attention_bwd_variant(L, Da // H)
    assert plan.split_proj == fused_ffn.split_k(Do, Da, rows)
    assert plan.split_qkv == fused_ffn.split_k(3 * Da, D, rows)
    ktiles = -(-rows // fused_ffn.K_TILE)
    for slices, per in (plan.split_proj, plan.split_qkv):
        assert 1 <= slices <= fused_ffn.MAX_SLICES
        assert (slices - 1) * per < ktiles <= slices * per


def test_backward_plan_at_the_train_shapes():
    """TimeSformer-B's train step: dw_proj's 36 output tiles take 8 slices,
    dw_qkv's 108 take 3 (the card's 132 SMs twice over)."""
    dense = fused_mhsa.backward_plan(64 * 197, 768, 768, 768, 12, 197)
    temporal = fused_mhsa.backward_plan(1568 * 8, 768, 768, 768, 12, 8)
    assert (dense.variant, temporal.variant) == ("dense", "packed")
    assert dense.split_proj[0] == temporal.split_proj[0] == 8
    assert dense.split_qkv[0] == temporal.split_qkv[0] == 3


def test_backward_plan_at_the_joint_shape():
    """ViViT-B joint space-time (8 clips of 1569 tokens): the long variant,
    and the weight gradients split as at every width."""
    rows = 8 * 1569
    plan = fused_mhsa.backward_plan(rows, 768, 768, 768, 12, 1569)
    assert plan.variant == "long"
    assert fused_mhsa.attention_variant(1569, 64) == "long"
    assert plan.split_proj == fused_ffn.split_k(768, 768, rows)
    assert plan.split_qkv == fused_ffn.split_k(3 * 768, 768, rows)


def test_long_variant_needs_the_forward_lse():
    """The long backward reads the forward's fp32 row log-sum-exp (nseq, H,
    L); without it, or at another shape, the wrapper raises before any
    launch. The other variants do not read it."""
    x = torch.zeros(2, 300, 64)
    with pytest.raises(ValueError, match="needs the forward's fp32 lse"):
        fused_mhsa._lse_arg("b", None, "long", 600, 300, 1, x)
    with pytest.raises(ValueError, match="needs the forward's fp32 lse"):
        fused_mhsa._lse_arg("b", torch.zeros(2, 1, 299), "long", 600, 300,
                            1, x)
    assert fused_mhsa._lse_arg("b", None, "dense", 600, 300, 1, x) is None
    assert fused_mhsa._lse_arg("b", torch.zeros(2, 1, 300), "long", 600,
                               300, 1, x) is not None


@pytest.mark.parametrize("rows,D,Da,Do,H,L,match", [
    (100, 96, 64, 96, 5, 10, "multiple of heads"),
    (100, 64, 64, 64, 1, 8, "sequences of 8"),
    (64, 100, 64, 100, 1, 8, "multiples of 8"),
    (64, 2048, 64, 2048, 1, 8, "at most 1024"),
    (64, 64, 68, 64, 2, 8, "multiples of 8"),
])
def test_backward_plan_refuses(rows, D, Da, Do, H, L, match):
    with pytest.raises(ValueError, match=match):
        fused_mhsa.backward_plan(rows, D, Da, Do, H, L)


def test_backward_launch_refuses_cpu_tensors():
    """The kernel wrappers take CUDA tensors only: a CPU tensor is the plain
    version's (the autograd.Function chooses), never the kernel's."""
    args = _mhsa_args(np.random.default_rng(0), 2, 8, 64)
    bf = [a.to(torch.bfloat16) for a in args]
    x, ln_w, ln_b, w_qkv, _, w_proj, _ = bf
    rows = 16
    qkv = torch.zeros(rows, 3 * 64, dtype=torch.bfloat16)
    attn = torch.zeros(rows, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="expected cuda"):
        fused_mhsa._launch_backward(x, x, qkv, attn, None, ln_w, ln_b,
                                    w_qkv, w_proj, 1, 0.125, 1e-5, True, 8)
    with pytest.raises(ValueError, match="expected cuda"):
        fused_mhsa._attn_bwd_launch(x, qkv, attn, None, ln_w, w_qkv, 1,
                                    0.125, 1e-5, 8)


# (BH, Nq, Nkv) of B6: the hd-64 long shapes (joint at 16 and 8 frames, the
# 448² spatial rows), MViT's (one split, and the blocks short of the card:
# split), ragged and unequal lengths, one tile
BWD_SHAPES = [(96, 3137, 3137), (96, 1569, 1569), (2304, 785, 785),
              (32, 1568, 393), (8, 25088, 393), (1, 6272, 1569),
              (3, 130, 260), (2, 1000, 300), (1, 64, 64), (1, 70, 1100)]


@pytest.mark.parametrize("BH,Nq,Nkv", BWD_SHAPES)
def test_bwd_splits_cover_every_query_tile_once(BH, Nq, Nkv):
    """The dk/dv pass's splits walk every 64-query tile of a slice once, no
    split empty; each 64-key block is one block of the grid per split, so
    every key sums every query tile once; the row arrays cover the query
    tiles."""
    fa = flash_attention
    splits, per = fa.bwd_splits(BH, Nq, Nkv)
    nqt = -(-Nq // 64)
    covered = np.zeros(nqt, int)
    for z in range(splits):
        tiles = range(z * per, min(nqt, (z + 1) * per))
        assert len(tiles) > 0
        covered[list(tiles)] += 1
    assert (covered == 1).all()
    assert fa.bwd_row_floats(BH, Nq) >= 2 * BH * nqt * 64
    assert fa.bwd_row_floats(BH, Nq) % (2 * BH * 128) == 0


@pytest.mark.parametrize("BH,Nq,Nkv", BWD_SHAPES)
def test_bwd_splits_depend_on_the_shape_alone(BH, Nq, Nkv):
    """The same shape gives the same splits (so the same order of the dk and
    dv sums, the same bits) on every call, whatever the head dim; the grid
    of key blocks and splits stays within two blocks a SM of an H100
    wherever the key blocks alone fall short of it."""
    fa = flash_attention
    splits, per = fa.bwd_splits(BH, Nq, Nkv)
    assert fa.bwd_splits(BH, Nq, Nkv) == (splits, per)
    blocks = -(-Nkv // 64) * BH
    if blocks >= 264:
        assert splits == 1
    else:
        assert blocks * splits <= 264 or per == 1
    for hd in (32, 64, 96):
        assert (fa.bwd_scratch_floats(BH, Nq, Nkv, hd) == 0) == (splits == 1)


@pytest.mark.parametrize("BH,Nq,Nkv,hd,floats", [
    (96, 3137, 3137, 64, 0),
    (2304, 785, 785, 64, 0),
    (1, 100, 2000, 64, 2 * 2 * 2000 * 64),      # two query tiles, split
    (32, 1568, 393, 96, 0),                     # MViT blocks 4-13
    (8, 25088, 393, 96, 2 * 4 * 8 * 393 * 96),  # block 1: four splits
    (1, 6272, 1569, 96, 2 * 10 * 1569 * 96),    # ten query splits
])
def test_bwd_scratch_floats(BH, Nq, Nkv, hd, floats):
    fa = flash_attention
    assert fa.bwd_scratch_floats(BH, Nq, Nkv, hd) == floats
