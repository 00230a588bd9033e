"""The port's CUDA kernels on a card, against their plain PyTorch versions.

These tests carry the ``cuda`` marker and skip without a card. They import
neither jax nor flax, so they run on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

(``--noconftest``: tests/conftest.py sets up jax for the JAX package's tests.)
The plain version runs in fp32 from the same bf16 inputs; tolerance
1e-2 · max|plain| for every output (forward, and each gradient of the
backward kernels), about two bf16 ulps of the output scale."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from videotransformer_tpu_torch.data import device_augment, pipeline
from videotransformer_tpu_torch.kernels import fused_ffn, fused_mhsa
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.training import trainer as trainer_mod

REL_TOL = 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bf16(rng, shape, std, mean=0.0):
    a = rng.standard_normal(shape, dtype=np.float32) * std + mean
    return torch.from_numpy(a).to("cuda", torch.bfloat16)


def _rel_err(got, want):
    assert torch.isfinite(got).all()
    return float((got.float() - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,H,block_diag,res", [
    (3, 65, 64, 4, 0, True),        # ragged dense N
    (2, 197, 64, 4, 0, False),      # the spatial length
    (4, 64, 64, 4, 8, False),       # block-diagonal
    (5, 9, 64, 4, 9, True),         # a length-9 (cls + 8) temporal row
    (42, 896, 768, 12, 8, True),    # the JAX package's packed layout
    (16, 197, 768, 12, 0, False),   # spatial at full width
    (2, 600, 64, 4, 0, True),       # too long for the tensor-core stage
])
def test_mhsa_kernel_matches_plain(cuda_device, B, N, D, H, block_diag, res):
    rng = np.random.default_rng(N + D)
    args = [_bf16(rng, (B, N, D), 1.0), _bf16(rng, (D,), 0.1, 1.0),
            _bf16(rng, (D,), 0.1), _bf16(rng, (3 * D, D), 0.03),
            _bf16(rng, (3 * D,), 0.03), _bf16(rng, (D, D), 0.03),
            _bf16(rng, (D,), 0.03)]
    tail = (H, (D // H) ** -0.5, 1e-5, res, block_diag)
    n0 = fused_mhsa.LAUNCHES
    out = fused_mhsa.fused_prenorm_mhsa(*args, *tail)
    torch.cuda.synchronize()
    assert fused_mhsa.LAUNCHES == n0 + 1
    want = fused_mhsa.fused_prenorm_mhsa_reference(
        *[a.float() for a in args], *tail)
    assert out.shape == want.shape and out.dtype == torch.bfloat16
    assert _rel_err(out, want) <= REL_TOL


def _mhsa_case(rng, B, N, D, Da, H):
    """bf16 x (B, N, D) and the weights of an MHSA of attention width Da."""
    return [_bf16(rng, (B, N, D), 1.0), _bf16(rng, (D,), 0.1, 1.0),
            _bf16(rng, (D,), 0.1), _bf16(rng, (3 * Da, D), 0.03),
            _bf16(rng, (3 * Da,), 0.03), _bf16(rng, (D, Da), 0.03),
            _bf16(rng, (D,), 0.03)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,Da,H,block_diag,variant", [
    (7, 197, 768, 768, 12, 0, "dense"),     # 1379 rows: ragged against 128
    (37, 8, 768, 768, 12, 8, "packed"),     # 296 temporal rows, ragged
    (3, 896, 768, 768, 12, 8, "packed"),    # the packed layout
    (5, 197, 768, 384, 6, 0, "dense"),      # attention width Da != D
    (9, 8, 768, 384, 6, 8, "packed"),       # the same, temporal
    (2, 100, 128, 128, 2, 0, "dense"),      # one key product (L <= 128)
    (3, 250, 128, 128, 2, 0, "dense"),      # 256 keys
    (2, 1569, 768, 768, 12, 0, "long"),     # joint space-time, 8 frames
    (16, 785, 768, 768, 12, 0, "long"),     # divided spatial at 448², 2x8
    (3, 300, 256, 128, 2, 0, "long"),       # ragged L, Da != D
    (2, 1000, 128, 192, 3, 0, "long"),
])
def test_mhsa_forward_variants_and_modes(cuda_device, B, N, D, Da, H,
                                         block_diag, variant):
    """B1 through each tensor-core attention kernel: out, and the saved qkv
    and attn (and lse, the long variant's), against the plain forward; the
    same bits of out with a gradient wanted (qkv and attn kept for the
    backward) and under inference_mode."""
    rng = np.random.default_rng(N + Da + B)
    args = _mhsa_case(rng, B, N, D, Da, H)
    tail = (H, (Da // H) ** -0.5, 1e-5, True, block_diag)
    assert fused_mhsa.attention_variant(block_diag or N, Da // H) == variant
    counts = dict(fused_mhsa.ATTENTION_LAUNCHES)
    out, qkv, attn, lse = fused_mhsa._launch(*args, *tail)
    torch.cuda.synchronize()
    assert fused_mhsa.ATTENTION_LAUNCHES[variant] == counts[variant] + 1
    want = fused_mhsa._forward_reference(*[a.float() for a in args], *tail)
    assert (lse is None) == (variant != "long")
    got = (out, qkv, attn) if lse is None else (out, qkv, attn, lse)
    for name, a, b in zip(("out", "qkv", "attn", "lse"), got, want):
        assert a.shape == b.shape, name
        assert _rel_err(a, b) <= REL_TOL, (name, _rel_err(a, b))
    x = args[0].detach().clone().requires_grad_()
    saved = fused_mhsa.fused_prenorm_mhsa(x, *args[1:], *tail)
    with torch.inference_mode():
        served = fused_mhsa.fused_prenorm_mhsa(*args, *tail)
    assert saved.grad_fn is not None
    assert torch.equal(saved.detach(), served)
    assert torch.equal(served.reshape(out.shape), out)


@pytest.mark.cuda
@pytest.mark.parametrize("M,D,hidden", [(150, 64, 256), (1000, 768, 3072)])
def test_ffn_kernel_matches_plain(cuda_device, M, D, hidden):
    rng = np.random.default_rng(M)
    args = [_bf16(rng, (M, D), 1.0), _bf16(rng, (D,), 0.1, 1.0),
            _bf16(rng, (D,), 0.1), _bf16(rng, (hidden, D), 0.03),
            _bf16(rng, (hidden,), 0.03), _bf16(rng, (D, hidden), 0.03),
            _bf16(rng, (D,), 0.03)]
    n0 = fused_ffn.LAUNCHES
    out = fused_ffn.fused_prenorm_ffn(*args)
    torch.cuda.synchronize()
    assert fused_ffn.LAUNCHES == n0 + 1
    want = fused_ffn.fused_prenorm_ffn_reference(*[a.float() for a in args])
    assert _rel_err(out, want) <= REL_TOL


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda_device):
    rng = np.random.default_rng(0)
    args = [_bf16(rng, s, 0.1) for s in
            [(16, 64), (64,), (64,), (128, 64), (128,), (64, 128), (64,)]]
    with pytest.raises(TypeError, match="expected bfloat16"):
        fused_ffn.fused_prenorm_ffn(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="not contiguous"):
        fused_ffn.fused_prenorm_ffn(args[0].t().contiguous().t(), *args[1:])
    d96 = [_bf16(rng, s, 0.1) for s in
           [(16, 96), (96,), (96,), (128, 96), (128,), (96, 128), (96,)]]
    with pytest.raises(ValueError, match="multiples of 64"):
        fused_ffn.fused_prenorm_ffn(*d96)


@pytest.mark.cuda
def test_tiny_model_on_card_matches_cpu(cuda_device):
    """A 2-layer D=64 TimeSformer in bf16: the card (kernels) against the
    CPU (plain versions) from the same weights and clip."""
    model = TimeSformer(num_frames=4, img_size=128, embed_dims=64,
                        num_heads=4, num_transformer_layers=2)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():  # make the zero-initialised temporal_fc count
        for layer in model.transformer_layers.layers:
            fc = layer.attentions[0].temporal_fc
            fc.weight.normal_(0, 0.05, generator=torch.Generator().manual_seed(1))
    clip = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 4, 3, 128, 128), dtype=np.float32)).to(torch.bfloat16)
    model = model.to(torch.bfloat16).eval()
    with torch.inference_mode():
        cpu = model(clip).float()
        m0, f0 = fused_mhsa.LAUNCHES, fused_ffn.LAUNCHES
        gpu = model.to(cuda_device)(clip.to(cuda_device)).float().cpu()
    assert (fused_mhsa.LAUNCHES - m0, fused_ffn.LAUNCHES - f0) == (4, 2)
    assert _rel_err(gpu, cpu) <= 5e-2


@pytest.mark.cuda
def test_model_at_another_size_never_syncs(cuda_device):
    """A 2-layer D=64 TimeSformer with an 8x8 position table on 160²
    clips (the table resized to 10x10 on every forward): the card against
    the CPU, the card's forward under ``set_sync_debug_mode("error")``
    (the resize weights go up once, from pinned memory, without a
    wait)."""
    model = TimeSformer(num_frames=4, img_size=128, embed_dims=64,
                        num_heads=4, num_transformer_layers=2)
    model.reset_parameters(torch.Generator().manual_seed(3))
    model = model.to(torch.bfloat16).eval()
    clip = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 4, 3, 160, 160), dtype=np.float32)).to(torch.bfloat16)
    with torch.inference_mode():
        cpu = model(clip).float()
        model.to(cuda_device)
        native = clip[..., :128, :128].to(cuda_device)
        model(native)  # the kernels built and loaded, at the native size
        clip = clip.to(cuda_device)
        torch.cuda.synchronize()
        m0 = fused_mhsa.LAUNCHES
        torch.cuda.set_sync_debug_mode("error")
        try:
            gpu = model(clip)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        gpu = gpu.float().cpu()
    assert fused_mhsa.LAUNCHES - m0 == 4
    assert _rel_err(gpu, cpu) <= 5e-2


@pytest.mark.cuda
def test_pretrained_import_on_card_matches_cpu(cuda_device, monkeypatch,
                                               tmp_path):
    """The trainer's ImageNet import (``-pretrain_pth``) on the card: every
    parameter bit-equal to the CPU trainer's, the same missing and
    unexpected names."""
    build = lambda c: TimeSformer(num_frames=2, img_size=32, embed_dims=64,
                                  num_heads=4, num_transformer_layers=2)
    monkeypatch.setattr(trainer_mod, "build_model", build)
    vit = build(None)
    vit.reset_parameters(torch.Generator().manual_seed(5))
    path = str(tmp_path / "vit.pth")
    torch.save({k: v for k, v in vit.state_dict().items()
                if "attentions.1" not in k and "temporal_fc" not in k
                and k != "time_embed"}, path)
    cfg = SimpleNamespace(
        objective="supervised", arch="timesformer",
        attention_type="divided_space_time", num_class=10, num_frames=2,
        img_size=32, optim_type="adamw", clip_grad=1.0, seed=0, mixup=False,
        use_fp16=True, pretrain_pth=path, weights_from="imagenet")
    cpu = trainer_mod.VideoTransformerTrainer(cfg, "cpu")
    card = trainer_mod.VideoTransformerTrainer(cfg, cuda_device)
    assert card.pretrained_keys == cpu.pretrained_keys
    assert "time_embed" in cpu.pretrained_keys[0]
    want = cpu.model.state_dict()
    for k, v in card.model.state_dict().items():
        assert v.device.type == "cuda"
        assert torch.equal(v.cpu(), want[k]), k


def _mhsa_bwd_case(rng, B, N, D, H, block_diag, res):
    """bf16 inputs of one MHSA backward: g, x, the forward's residuals
    (qkv, attn from the plain forward) and the weights."""
    x = _bf16(rng, (B, N, D), 1.0)
    w = [_bf16(rng, (D,), 0.1, 1.0), _bf16(rng, (D,), 0.1),
         _bf16(rng, (3 * D, D), 0.03), _bf16(rng, (3 * D,), 0.03),
         _bf16(rng, (D, D), 0.03), _bf16(rng, (D,), 0.03)]
    cfg = (H, (D // H) ** -0.5, 1e-5, res, block_diag)
    _, qkv, attn, lse = fused_mhsa._forward_reference(x, *w, *cfg)
    g = _bf16(rng, (B, N, D), 1.0)
    ln_w, ln_b, w_qkv, _, w_proj, _ = w
    return (g, x, qkv, attn, lse, ln_w, ln_b, w_qkv, w_proj), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,H,block_diag,res", [
    (3, 65, 64, 4, 0, True),        # head dim 16: the CUDA-core kernel
    (3, 65, 64, 1, 0, True),        # ragged dense N on the tensor cores
    (2, 197, 64, 1, 0, False),      # the spatial length
    (4, 64, 64, 4, 8, False),       # block-diagonal
    (5, 9, 64, 4, 9, True),         # a length-9 (cls + 8) temporal row
    (8, 197, 768, 12, 0, False),    # spatial at full width
    (196, 8, 768, 12, 8, False),    # temporal at full width
])
def test_mhsa_backward_kernel_matches_plain(cuda_device, B, N, D, H,
                                            block_diag, res):
    rng = np.random.default_rng(N + D + 1)
    args, cfg = _mhsa_bwd_case(rng, B, N, D, H, block_diag, res)
    n0 = fused_mhsa.BWD_LAUNCHES
    got = fused_mhsa._launch_backward(*args, *cfg)
    torch.cuda.synchronize()
    assert fused_mhsa.BWD_LAUNCHES == n0 + 1
    want = fused_mhsa.fused_prenorm_mhsa_backward_reference(
        *[a.float() for a in args[:4] + args[5:]], *cfg)  # no lse
    names = ("dx", "dln_w", "dln_b", "dw_qkv", "db_qkv", "dw_proj", "db_proj")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        assert _rel_err(a, b) <= REL_TOL, (name, _rel_err(a, b))
    again = fused_mhsa._launch_backward(*args, *cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,H", [(300, 128, 2), (1569, 768, 12)])
def test_long_rows_never_take_a_plain_version(cuda_device, monkeypatch, N, D,
                                              H):
    """A CUDA tensor at L > 256, head dim 64, goes through B1's and B3's
    long variant, forward and backward, with every plain version (and
    scaled_dot_product_attention) made to raise."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for mod, name in ((fused_mhsa, "_forward_reference"),
                      (fused_mhsa, "_attn_bwd_reference"),
                      (fused_mhsa, "fused_prenorm_mhsa_reference"),
                      (fused_mhsa, "fused_prenorm_mhsa_backward_reference"),
                      (torch.nn.functional, "scaled_dot_product_attention")):
        monkeypatch.setattr(mod, name, refuse)
    rng = np.random.default_rng(N)
    args = _mhsa_case(rng, 2, N, D, D, H)
    x = args[0].detach().clone().requires_grad_()
    fwd = dict(fused_mhsa.ATTENTION_LAUNCHES)
    bwd = dict(fused_mhsa.ATTENTION_BWD_LAUNCHES)
    out = fused_mhsa.fused_prenorm_mhsa(x, *args[1:], H, 64 ** -0.5)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert torch.isfinite(x.grad).all()
    assert fused_mhsa.ATTENTION_LAUNCHES["long"] == fwd["long"] + 1
    assert fused_mhsa.ATTENTION_BWD_LAUNCHES["long"] == bwd["long"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("M,D,eps", [
    (37656, 768, 1e-5),   # serving: 8 clips x 3 crops, TimeSformer-B
    (12552, 768, 1e-5),   # the TimeSformer train step, 8 clips
    (50176, 192, 1e-6),   # MViT-B blocks 1, 3-12, 13-14 at batch 8
    (12544, 384, 1e-6),
    (12544, 768, 1e-6),
    (1003, 384, 1e-6),    # ragged against the 128-row tiles
])
def test_ffn_forward_at_main_shapes(cuda_device, M, D, eps, save):
    """B2 on the wgmma/TMA core at each main path's width, with h_pre saved
    (training) and without (serving): out and h_pre against the plain
    forward in fp32, and out the same bits in both modes."""
    hidden = 4 * D
    rng = np.random.default_rng(M + D)
    x = _bf16(rng, (M, D), 1.0)
    w = [_bf16(rng, (D,), 0.1, 1.0), _bf16(rng, (D,), 0.1),
         _bf16(rng, (hidden, D), 0.02), _bf16(rng, (hidden,), 0.02),
         _bf16(rng, (D, hidden), 0.02), _bf16(rng, (D,), 0.02)]
    n0 = fused_ffn.LAUNCHES
    out, h_pre = fused_ffn._launch(x, *w, eps, save)
    torch.cuda.synchronize()
    assert fused_ffn.LAUNCHES == n0 + 1
    want_out, want_h = fused_ffn._forward_reference(
        *[a.float() for a in (x, *w)], eps)
    assert _rel_err(out, want_out) <= REL_TOL, _rel_err(out, want_out)
    if save:
        assert _rel_err(h_pre, want_h) <= REL_TOL, _rel_err(h_pre, want_h)
    else:
        assert h_pre is None
    other, _ = fused_ffn._launch(x, *w, eps, not save)
    assert torch.equal(out, other)


# (B, N, D, Da, H, block_diag, variant): B3 through each attention backward
# kernel at Da != D
MHSA_BWD_VARIANTS = [
    (3, 197, 256, 128, 2, 0, "dense"),     # the spatial length, 128 + 80 keys
    (4, 65, 128, 64, 1, 0, "dense"),       # ragged against the 64-row tiles
    (2, 256, 128, 192, 3, 0, "dense"),     # 256 keys
    (37, 8, 768, 384, 6, 8, "packed"),     # temporal, 296 rows: ragged
    (5, 32, 128, 256, 4, 32, "packed"),    # two sequences a tile
    (7, 9, 128, 64, 1, 9, "general"),      # cls + 8: the CUDA-core kernel
    (2, 1569, 768, 768, 12, 0, "long"),    # joint space-time, 8 frames
    (3, 300, 256, 128, 2, 0, "long"),      # ragged L, Da != D
    (2, 1000, 128, 192, 3, 0, "long"),     # and split dk/dv partials
]


@pytest.mark.cuda
@pytest.mark.parametrize("res", [True, False])
@pytest.mark.parametrize("B,N,D,Da,H,block_diag,variant", MHSA_BWD_VARIANTS)
def test_mhsa_backward_variants(cuda_device, B, N, D, Da, H, block_diag,
                                variant, res):
    """The whole backward (one call) against the plain backward in fp32, and
    B3 alone (attention, d_xn, LayerNorm backward, sums) against its plain
    version; each twice to the same bits."""
    rng = np.random.default_rng(N + Da + B)
    x = _bf16(rng, (B, N, D), 1.0)
    w = [_bf16(rng, (D,), 0.1, 1.0), _bf16(rng, (D,), 0.1),
         _bf16(rng, (3 * Da, D), 0.03), _bf16(rng, (3 * Da,), 0.03),
         _bf16(rng, (D, Da), 0.03), _bf16(rng, (D,), 0.03)]
    cfg = (H, (Da // H) ** -0.5, 1e-5, res, block_diag)
    assert fused_mhsa.attention_bwd_variant(block_diag or N, Da // H) == \
        variant
    _, qkv, attn, lse = fused_mhsa._forward_reference(x, *w, *cfg)
    g = _bf16(rng, (B, N, D), 1.0)
    ln_w, ln_b, w_qkv, _, w_proj, _ = w
    args = (g, x, qkv, attn, lse, ln_w, ln_b, w_qkv, w_proj)
    counts = dict(fused_mhsa.ATTENTION_BWD_LAUNCHES)
    got = fused_mhsa._launch_backward(*args, *cfg)
    torch.cuda.synchronize()
    assert fused_mhsa.ATTENTION_BWD_LAUNCHES[variant] == counts[variant] + 1
    want = fused_mhsa.fused_prenorm_mhsa_backward_reference(
        *[a.float() for a in args[:4] + args[5:]], *cfg)  # no lse
    names = ("dx", "dln_w", "dln_b", "dw_qkv", "db_qkv", "dw_proj", "db_proj")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        assert _rel_err(a, b) <= REL_TOL, (name, _rel_err(a, b))
    again = fused_mhsa._launch_backward(*args, *cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics
    do = (g.float().reshape(-1, D) @ w_proj.float()).to(torch.bfloat16)
    core = (x, qkv, do, g.reshape(-1, D) if res else None, ln_w, w_qkv, H,
            cfg[1], 1e-5, block_diag)
    got = fused_mhsa._attn_bwd_launch(*core, attn=attn, lse=lse)
    want = fused_mhsa._attn_bwd_reference(
        *[a.float() if torch.is_tensor(a) else a for a in core])
    for name, a, b in zip(("dqkv", "dx", "dln_w", "dln_b", "dbqkv"), got,
                          want):
        assert _rel_err(a, b) <= REL_TOL, (name, _rel_err(a, b))
    again = fused_mhsa._attn_bwd_launch(*core, attn=attn, lse=lse)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# (B, N, D, Da, H, block_diag, variant): B3's recompute mode at the train
# step's shapes, through each attention variant and at a tp = 2 shard
MHSA_RECOMPUTE_CASES = [
    (64, 197, 768, 768, 12, 0, "dense"),   # TimeSformer-B spatial, 8 clips
    (1568, 8, 768, 768, 12, 8, "packed"),  # its temporal rows
    (2, 1569, 768, 768, 12, 0, "long"),    # joint space-time, 8 frames
    (8, 9, 768, 768, 12, 0, "general"),    # the fact_encoder's temporal stack
    (24, 197, 768, 384, 6, 0, "dense"),    # a tp = 2 shard, Da != D
]


@pytest.mark.cuda
@pytest.mark.parametrize("res", [True, False])
@pytest.mark.parametrize("B,N,D,Da,H,block_diag,variant",
                         MHSA_RECOMPUTE_CASES)
def test_mhsa_recompute_backward(cuda_device, B, N, D, Da, H, block_diag,
                                 variant, res):
    """B3's recompute mode (qkv rebuilt from x): the rebuilt qkv bit-equal
    to B1's saved qkv, the whole call's seven gradients bit-equal to the
    call from the saved qkv, and within REL_TOL of the plain backward that
    rebuilds qkv (qkv None)."""
    rng = np.random.default_rng(N + Da + B + 7)
    args = _mhsa_case(rng, B, N, D, Da, H)
    cfg = (H, (Da // H) ** -0.5, 1e-5, res, block_diag)
    assert fused_mhsa.attention_bwd_variant(block_diag or N, Da // H) == \
        variant
    _, qkv, attn, lse = fused_mhsa._launch(*args, *cfg)
    x, ln_w, ln_b, w_qkv, b_qkv, w_proj, _ = args
    rebuilt = fused_mhsa._recompute_qkv_launch(x, ln_w, ln_b, w_qkv, b_qkv,
                                               1e-5)
    assert torch.equal(rebuilt, qkv)
    g = _bf16(rng, (B, N, D), 1.0)
    rest = (ln_w, ln_b, w_qkv, w_proj)
    saved = fused_mhsa._launch_backward(g, x, qkv, attn, lse, *rest, *cfg)
    counts = dict(fused_mhsa.ATTENTION_BWD_LAUNCHES)
    got = fused_mhsa._launch_backward(g, x, None, attn, lse, *rest, *cfg,
                                      b_qkv=b_qkv)
    torch.cuda.synchronize()
    assert fused_mhsa.ATTENTION_BWD_LAUNCHES[variant] == counts[variant] + 1
    assert fused_mhsa.ATTENTION_BWD_LAUNCHES["recompute"] == \
        counts["recompute"] + 1
    assert all(torch.equal(a, b) for a, b in zip(got, saved))
    want = fused_mhsa.fused_prenorm_mhsa_backward_reference(
        g.float(), x.float(), None, attn.float(),
        *[a.float() for a in rest], *cfg, b_qkv=b_qkv.float())
    names = ("dx", "dln_w", "dln_b", "dw_qkv", "db_qkv", "dw_proj", "db_proj")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        assert _rel_err(a, b) <= REL_TOL, (name, _rel_err(a, b))


def _remat_steps(cuda_device, monkeypatch, remat, recompute):
    """Two bf16 steps of a 2-layer TimeSformer (width 128, 2 heads: head
    dim 64) with DropPath 0.1 through the kernels, from the trainer's
    initialisation at seed 0: per step the loss, the grad norm and the
    launches, and the trainer."""
    monkeypatch.setattr(trainer_mod, "build_model", lambda c: TimeSformer(
        num_frames=2, img_size=32, embed_dims=128, num_heads=2,
        num_transformer_layers=2, drop_path_rate=0.1, remat=c.remat))
    monkeypatch.setattr(fused_mhsa, "RECOMPUTE_QKV", recompute)
    cfg = SimpleNamespace(
        objective="supervised", arch="timesformer",
        attention_type="divided_space_time", num_class=10, num_frames=2,
        img_size=32, optim_type="adamw", clip_grad=1.0, seed=0, mixup=False,
        use_fp16=True, remat=remat)
    tr = trainer_mod.VideoTransformerTrainer(cfg, cuda_device)
    batch = {"video": np.random.default_rng(8).standard_normal(
        (4, 2, 3, 32, 32), dtype=np.float32), "label": np.arange(4)}
    steps = []
    for _ in range(2):
        n0 = (fused_mhsa.LAUNCHES, fused_ffn.LAUNCHES,
              fused_mhsa.BWD_LAUNCHES, fused_ffn.BWD_LAUNCHES,
              fused_mhsa.ATTENTION_BWD_LAUNCHES["recompute"])
        st = tr.train_step(batch, 1e-3, 0.05)
        n1 = (fused_mhsa.LAUNCHES, fused_ffn.LAUNCHES,
              fused_mhsa.BWD_LAUNCHES, fused_ffn.BWD_LAUNCHES,
              fused_mhsa.ATTENTION_BWD_LAUNCHES["recompute"])
        steps.append((float(st["loss"]), float(st["grad_norm"]),
                      tuple(b - a for a, b in zip(n0, n1))))
    return steps, tr


@pytest.mark.cuda
@pytest.mark.parametrize("remat,recompute", [(True, False), (False, True),
                                             (True, True)])
def test_remat_steps_bit_equal_on_card(cuda_device, monkeypatch, remat,
                                       recompute):
    """Remat, RECOMPUTE_QKV or both against neither, from the same
    parameters: losses, grad norms and every parameter bit-equal; remat
    launches each block's forward kernels twice, RECOMPUTE_QKV makes every
    B3 call rebuild qkv."""
    plain, ref = _remat_steps(cuda_device, monkeypatch, False, False)
    got, tr = _remat_steps(cuda_device, monkeypatch, remat, recompute)
    assert [s[:2] for s in got] == [s[:2] for s in plain]
    want = ref.model.state_dict()
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    forwards = 2 if remat else 1
    assert plain[0][2] == (4, 2, 4, 2, 0)
    assert got[0][2] == (4 * forwards, 2 * forwards, 4, 2,
                         4 if recompute else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("M,D,hidden", [(150, 64, 256), (1000, 768, 3072)])
def test_ffn_backward_kernel_matches_plain(cuda_device, M, D, hidden):
    rng = np.random.default_rng(M + 1)
    x = _bf16(rng, (M, D), 1.0)
    w = [_bf16(rng, (D,), 0.1, 1.0), _bf16(rng, (D,), 0.1),
         _bf16(rng, (hidden, D), 0.03), _bf16(rng, (hidden,), 0.03),
         _bf16(rng, (D, hidden), 0.03), _bf16(rng, (D,), 0.03)]
    _, h_pre = fused_ffn._forward_reference(x, *w, 1e-5)
    g = _bf16(rng, (M, D), 1.0)
    args = (g, x, h_pre, w[0], w[1], w[2], w[4])
    n0 = fused_ffn.BWD_LAUNCHES
    got = fused_ffn._launch_backward(*args, 1e-5)
    torch.cuda.synchronize()
    assert fused_ffn.BWD_LAUNCHES == n0 + 1
    want = fused_ffn.fused_prenorm_ffn_backward_reference(
        *[a.float() for a in args], 1e-5)
    names = ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        assert _rel_err(a, b) <= REL_TOL, (name, _rel_err(a, b))
    again = fused_ffn._launch_backward(*args, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


@pytest.mark.cuda
def test_ffn_forward_saves_h_pre(cuda_device):
    rng = np.random.default_rng(3)
    x = _bf16(rng, (300, 64), 1.0)
    w = [_bf16(rng, (64,), 0.1, 1.0), _bf16(rng, (64,), 0.1),
         _bf16(rng, (256, 64), 0.03), _bf16(rng, (256,), 0.03),
         _bf16(rng, (64, 256), 0.03), _bf16(rng, (64,), 0.03)]
    out, h_pre = fused_ffn._launch(x, *w, 1e-5, True)
    want_out, want_h = fused_ffn._forward_reference(
        *[a.float() for a in (x, *w)], 1e-5)
    assert _rel_err(out, want_out) <= REL_TOL
    assert _rel_err(h_pre, want_h) <= REL_TOL


@pytest.mark.cuda
def test_tiny_train_step_on_card_matches_cpu(cuda_device, monkeypatch):
    """Two bf16 train steps of a 2-layer D=64 TimeSformer (no DropPath, no
    mixup) on the card (kernels, forward and backward) and on the CPU
    (plain versions) from the same parameters: losses within 2e-2 relative
    (bf16 rounding flips in two blocks and two optimizer steps)."""
    from types import SimpleNamespace

    monkeypatch.setattr(trainer_mod, "build_model", lambda c: TimeSformer(
        num_frames=2, img_size=32, embed_dims=64, num_heads=4,
        num_transformer_layers=2, drop_path_rate=0.0))
    cfg = SimpleNamespace(
        objective="supervised", arch="timesformer",
        attention_type="divided_space_time", num_class=10, num_frames=2,
        img_size=32, optim_type="adamw", clip_grad=1.0, seed=0, mixup=False,
        use_fp16=True)
    cpu = trainer_mod.VideoTransformerTrainer(cfg, "cpu")
    card = trainer_mod.VideoTransformerTrainer(cfg, cuda_device,
                                               params=cpu.params_tree())
    rng = np.random.default_rng(5)
    batch = {"video": rng.standard_normal((4, 2, 3, 32, 32),
                                          dtype=np.float32),
             "label": np.arange(4)}
    m0, b0 = fused_mhsa.LAUNCHES, fused_mhsa.BWD_LAUNCHES
    f0, c0 = fused_ffn.LAUNCHES, fused_ffn.BWD_LAUNCHES
    for _ in range(2):
        a = cpu.train_step(batch, 1e-3, 0.05)
        b = card.train_step(batch, 1e-3, 0.05)
        la, lb = float(a["loss"]), float(b["loss"])
        assert np.isfinite(lb) and abs(la - lb) <= 2e-2 * abs(la), (la, lb)
    assert (fused_mhsa.LAUNCHES - m0, fused_mhsa.BWD_LAUNCHES - b0,
            fused_ffn.LAUNCHES - f0, fused_ffn.BWD_LAUNCHES - c0) == \
        (8, 8, 4, 4)


@pytest.mark.cuda
def test_train_step_with_mixup_and_drop_path_on_card(cuda_device,
                                                     monkeypatch):
    """Mixup draws and DropPath masks from the trainer's CUDA generator: a
    tiny bf16 step runs through the kernels, and the same seed and step give
    the same loss twice."""
    from types import SimpleNamespace

    monkeypatch.setattr(trainer_mod, "build_model", lambda c: TimeSformer(
        num_frames=2, img_size=32, embed_dims=64, num_heads=4,
        num_transformer_layers=2, drop_path_rate=0.3))
    cfg = SimpleNamespace(
        objective="supervised", arch="timesformer",
        attention_type="divided_space_time", num_class=10, num_frames=2,
        img_size=32, optim_type="adamw", clip_grad=1.0, seed=0, mixup=True,
        use_fp16=True)
    batch = {"video": np.random.default_rng(6).standard_normal(
        (4, 2, 3, 32, 32), dtype=np.float32), "label": np.arange(4)}
    losses = []
    for _ in range(2):
        tr = trainer_mod.VideoTransformerTrainer(cfg, cuda_device)
        b0 = fused_mhsa.BWD_LAUNCHES
        losses.append(float(tr.train_step(batch, 1e-3, 0.05)["loss"]))
        assert fused_mhsa.BWD_LAUNCHES - b0 == 4
    assert np.isfinite(losses).all() and losses[0] == losses[1], losses


def _flash_case(rng, BH, Nq, Nkv, hd):
    """bf16 q (1, BH, Nq, hd), k and v (1, BH, Nkv, hd), scale hd^-0.5."""
    q = _bf16(rng, (1, BH, Nq, hd), 1.0)
    k = _bf16(rng, (1, BH, Nkv, hd), 1.0)
    v = _bf16(rng, (1, BH, Nkv, hd), 1.0)
    return q, k, v, hd ** -0.5


@pytest.mark.cuda
@pytest.mark.parametrize("BH,Nq,Nkv,hd", [
    (3, 70, 50, 32),        # both edges ragged, Nkv < one tile
    (2, 130, 260, 64),      # Nq < Nkv
    (4, 197, 197, 96),      # dense, ragged
    (2, 1568, 393, 96),     # MViT blocks 4-13 (per b·h)
    (1, 6272, 1569, 96),    # MViT block 1: K/V above shared memory
    (2, 100, 129, 128),
    (3, 300, 250, 96),      # ragged against both tiles, three slices
    (12, 3137, 3137, 64),   # joint space-time TimeSformer-B, 16 frames
])
def test_flash_attention_kernels_match_plain(cuda_device, BH, Nq, Nkv, hd):
    """B5 against the plain forward, and B6 (every gradient) against the
    plain backward, both run in fp32 from the same bf16 inputs and the
    kernel's own o and lse; B6 twice gives the same bits."""
    from videotransformer_tpu_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(Nq + Nkv + hd)
    q, k, v, scale = _flash_case(rng, BH, Nq, Nkv, hd)
    n0, b0 = fa.LAUNCHES, fa.BWD_LAUNCHES
    o, lse = fa._launch(q, k, v, scale)
    torch.cuda.synchronize()
    want_o, want_lse = fa._forward_reference(q.float(), k.float(), v.float(),
                                             scale)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert _rel_err(o, want_o) <= REL_TOL, _rel_err(o, want_o)
    assert float((lse - want_lse).abs().max()) <= 1e-3
    do = _bf16(rng, tuple(q.shape), 1.0)
    got = fa._launch_backward(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    want = fa.flash_attention_backward_reference(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == torch.bfloat16, name
        assert _rel_err(a, b) <= REL_TOL, (name, _rel_err(a, b))
    again = fa._launch_backward(q, k, v, o, lse, do, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics
    assert (fa.LAUNCHES - n0, fa.BWD_LAUNCHES - b0) == (1, 2)


@pytest.mark.cuda
def test_flash_attention_function_on_card(cuda_device):
    """The autograd.Function launches B5 and B6 on CUDA bf16 tensors and
    raises on what the kernels do not take."""
    from videotransformer_tpu_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(4)
    q, k, v, scale = _flash_case(rng, 2, 100, 40, 64)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    n0, b0 = fa.LAUNCHES, fa.BWD_LAUNCHES
    out = fa.flash_attention(q, k, v, scale)
    out.float().square().sum().backward()
    assert (fa.LAUNCHES - n0, fa.BWD_LAUNCHES - b0) == (1, 1)
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
    with pytest.raises(TypeError, match="expected bfloat16"):
        fa.flash_attention(q.detach().float(), k.detach().float(),
                           v.detach().float(), scale)
    odd = _bf16(rng, (1, 2, 40, 48), 1.0)
    with pytest.raises(ValueError, match="head dim 48"):
        fa.flash_attention(odd, odd, odd, scale)
    with pytest.raises(ValueError, match="not positive"):
        fa.flash_attention(q.detach(), k.detach(), v.detach(), -scale)


@pytest.mark.cuda
@pytest.mark.parametrize("M,D", [(50176, 192), (12544, 384), (12544, 768),
                                 (1003, 384)])
def test_ffn_kernels_at_mvit_widths(cuda_device, M, D):
    """B2 and B4 at MViT's fused-FFN widths (blocks 1, 3-12 and 13-14 at
    batch 8) and at a ragged row count, with LayerNorm eps 1e-6, against the
    plain versions in fp32; B4's split weight gradients give the same bits
    twice."""
    hidden, eps = 4 * D, 1e-6
    rng = np.random.default_rng(D)
    x = _bf16(rng, (M, D), 1.0)
    w = [_bf16(rng, (D,), 0.1, 1.0), _bf16(rng, (D,), 0.1),
         _bf16(rng, (hidden, D), 0.03), _bf16(rng, (hidden,), 0.03),
         _bf16(rng, (D, hidden), 0.03), _bf16(rng, (D,), 0.03)]
    out, h_pre = fused_ffn._launch(x, *w, eps, True)
    want_out, _ = fused_ffn._forward_reference(
        *[a.float() for a in (x, *w)], eps)
    assert _rel_err(out, want_out) <= REL_TOL
    g = _bf16(rng, (M, D), 1.0)
    args = (g, x, h_pre, w[0], w[1], w[2], w[4])
    got = fused_ffn._launch_backward(*args, eps)
    want = fused_ffn.fused_prenorm_ffn_backward_reference(
        *[a.float() for a in args], eps)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= REL_TOL, _rel_err(a, b)
    again = fused_ffn._launch_backward(*args, eps)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


@pytest.mark.cuda
def test_skip_maxpool_backward_repeats_on_card(cuda_device):
    """MViT's skip max pool at block 1 (batch 8, 8x56x56x96, bf16): the same
    output as F.max_pool3d, a gradient within 1e-2 of its fp32 gradient, and
    the same bits twice (F.max_pool3d's backward adds with atomics)."""
    import torch.nn.functional as F

    from videotransformer_tpu_torch.models import mvit

    rng = np.random.default_rng(8)
    x = _bf16(rng, (8, 8, 56, 56, 96), 1.0).requires_grad_()
    g = _bf16(rng, (8, 8, 28, 28, 96), 1.0)
    args = ((1, 3, 3), (1, 2, 2), (0, 1, 1))
    y = mvit._maxpool3d(x, *args)
    grads = [torch.autograd.grad(y, x, g, retain_graph=True)[0]
             for _ in range(2)]
    xf = x.detach().float().permute(0, 4, 1, 2, 3).requires_grad_()
    want = F.max_pool3d(xf, *args).permute(0, 2, 3, 4, 1)
    want_g, = torch.autograd.grad(want, xf, g.float())
    assert torch.equal(y.float(), want)
    assert _rel_err(grads[0], want_g.permute(0, 2, 3, 4, 1)) <= REL_TOL
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
def test_tiny_mim_step_on_card_matches_cpu(cuda_device, monkeypatch):
    """Two bf16 MaskFeat steps (depth 4, HOG targets from the raw clip on the
    device) on the card (B5/B6 and B2/B4) and on the CPU (plain versions)
    from the same parameters: losses within 2e-2 relative (bf16 rounding
    flips in four blocks and two optimizer steps)."""
    from types import SimpleNamespace

    from videotransformer_tpu_torch.kernels import flash_attention as fa
    from videotransformer_tpu_torch.models.maskfeat import MaskFeat

    monkeypatch.setattr(trainer_mod, "build_model", lambda c: MaskFeat(
        img_size=32, num_frames=4, depth=4,
        embed_dim_mul=((1, 2.0), (3, 2.0)),
        atten_head_mul=((1, 2.0), (3, 2.0)),
        pool_q_stride_size=((1, 1, 2, 2), (3, 1, 2, 2))))
    cfg = SimpleNamespace(objective="mim", arch="mvit", num_class=10,
                          num_frames=4, img_size=32, optim_type="adamw",
                          clip_grad=1.0, seed=0, use_fp16=True)
    cpu = trainer_mod.VideoTransformerTrainer(cfg, "cpu")
    card = trainer_mod.VideoTransformerTrainer(cfg, cuda_device,
                                               params=cpu.params_tree())
    rng = np.random.default_rng(7)
    raw = rng.integers(0, 256, (2, 4, 3, 32, 32)).astype(np.float32)
    markers = np.zeros((2, 2, 2), np.int32)
    markers[:, 0] = [0, 2]
    batch = {"video": (raw / 255.0 - 0.45) / 0.225, "raw": raw,
             "mask": np.ones((2, 2, 2, 2), np.int32), "cube_marker": markers,
             "cube_count": np.ones(2, np.int32)}
    counts0 = (fa.LAUNCHES, fa.BWD_LAUNCHES, fused_ffn.LAUNCHES,
               fused_ffn.BWD_LAUNCHES)
    for _ in range(2):
        a = cpu.train_step(batch, 1e-3, 0.05)
        b = card.train_step(batch, 1e-3, 0.05)
        la, lb = float(a["loss"]), float(b["loss"])
        assert np.isfinite(lb) and abs(la - lb) <= 2e-2 * abs(la), (la, lb)
    counts = (fa.LAUNCHES, fa.BWD_LAUNCHES, fused_ffn.LAUNCHES,
              fused_ffn.BWD_LAUNCHES)
    assert tuple(x - y for x, y in zip(counts, counts0)) == (8, 8, 4, 4)


# ------------------------------------------------------------ the data path

AUG_RECIPES = {
    "supervised": {},
    "jitter_with_hue": {"color": (0.4, 0.4, 0.4, 0.1)},
    "auto_augment": {"auto_augment": True},
    "mim_with_raw": {"scale": (0.5, 1.0), "color": (0, 0, 0, 0),
                     "with_raw": True},
}


def _uint8_clips(seed, shape=(4, 3, 64, 86, 3)):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, shape, dtype=np.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", sorted(AUG_RECIPES))
def test_augment_on_card_matches_cpu(cuda_device, recipe):
    """The same draws (made on the card, copied to the CPU) on both
    devices: within 5e-2 of a 0-255 pixel (the card fuses multiply-adds, so
    a crop's source coordinate moves by an ulp, ~3e-5 px, and a noise
    clip's value by up to its gradient times that: chip_smoke.py measured
    1.93e-2), but RandAugment's discontinuous ops, which may land a pixel
    on the other side of a step: at most 0.1% of the elements apart."""
    kw = dict(AUG_RECIPES[recipe])
    with_raw = kw.pop("with_raw", False)
    raw = _uint8_clips(1)
    g = torch.Generator(device="cuda").manual_seed(0)
    draws = device_augment.draw_augment(g, raw.shape, device=cuda_device,
                                        **kw)
    got = device_augment.augment_batch(raw.to(cuda_device), out_size=56,
                                       with_raw=with_raw, draws=draws, **kw)
    want = device_augment.augment_batch(
        raw, out_size=56, with_raw=with_raw,
        draws={k: v.cpu() for k, v in draws.items()}, **kw)
    pairs = zip(got, want) if with_raw else [(got, want)]
    for (a, b), scale in zip(pairs, (255 * 0.225, 1.0)):
        err = (a.cpu() - b).abs() * scale
        if kw.get("auto_augment"):
            assert (err > 5e-2).float().mean() <= 1e-3, err.max()
        else:
            assert err.max() <= 5e-2, err.max()


@pytest.mark.cuda
@pytest.mark.parametrize("three_crop", [False, True])
def test_eval_preprocess_on_card_matches_cpu(cuda_device, three_crop):
    raw = _uint8_clips(2, (2, 3, 256, 342, 3))
    got = device_augment.eval_preprocess_batch(raw.to(cuda_device),
                                               three_crop=three_crop)
    want = device_augment.eval_preprocess_batch(raw, three_crop=three_crop)
    assert got.shape == want.shape == (6 if three_crop else 2, 3, 3, 224, 224)
    assert ((got.cpu() - want).abs() * 255 * 0.225).max() <= 5e-2


@pytest.mark.cuda
def test_augment_never_syncs_with_the_host(cuda_device):
    """Every recipe's draws and apply, and both eval recipes, under
    ``set_sync_debug_mode("error")``: a synchronising call raises."""
    raw = _uint8_clips(3).to(cuda_device)
    g = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for kw in AUG_RECIPES.values():
            device_augment.augment_batch(raw, out_size=56, generator=g, **kw)
        for three_crop in (False, True):
            device_augment.eval_preprocess_batch(raw, img_size=56,
                                                 three_crop=three_crop)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_prefetch_ring_survives_a_copy_still_in_flight(cuda_device):
    """Eight 16 MB batches, each filled with its index. Before asking for
    the next batch the consumer stalls the copy stream, so the copy of a
    batch is still waiting when the ring comes back to its pinned buffer:
    without the event wait the host would overwrite that buffer first, and
    a later batch's values would arrive."""
    n = 8
    batches = ({"x": np.full((16, 1024, 1024), i, np.uint8),
                "label": np.array([i], np.int32)} for i in range(n))
    side = torch.cuda.Stream()
    seen = []
    for batch in pipeline.device_prefetch(batches, cuda_device, stream=side):
        assert batch["x"].device.type == "cuda"
        seen.append((batch["x"].float().mean(), batch["label"]))
        with torch.cuda.stream(side):
            torch.cuda._sleep(20_000_000)  # the next copies wait behind it
    torch.cuda.synchronize()
    assert [float(m) for m, _ in seen] == list(map(float, range(n)))
    assert [int(lab) for _, lab in seen] == list(range(n))


@pytest.mark.cuda
def test_tiny_raw_video_step_on_card_matches_cpu(cuda_device, monkeypatch):
    """Two bf16 raw_video steps of the tiny TimeSformer on the card and on
    the CPU with the same augment draws: losses within 2e-2 relative (as
    the float step above), the kernels launched on the card."""
    from types import SimpleNamespace

    monkeypatch.setattr(trainer_mod, "build_model", lambda c: TimeSformer(
        num_frames=2, img_size=32, embed_dims=64, num_heads=4,
        num_transformer_layers=2, drop_path_rate=0.0))
    cfg = SimpleNamespace(
        objective="supervised", arch="timesformer",
        attention_type="divided_space_time", num_class=10, num_frames=2,
        img_size=32, optim_type="adamw", clip_grad=1.0, seed=0, mixup=False,
        use_fp16=True)
    cpu = trainer_mod.VideoTransformerTrainer(cfg, "cpu")
    card = trainer_mod.VideoTransformerTrainer(cfg, cuda_device,
                                               params=cpu.params_tree())
    raw = _uint8_clips(4, (4, 2, 40, 52, 3))
    batch = {"raw_video": raw.numpy(), "label": np.arange(4)}
    draws = device_augment.draw_augment(torch.Generator().manual_seed(2),
                                        raw.shape)
    monkeypatch.setattr(trainer_mod, "draw_augment", lambda *a, device=None,
                        **k: {n: v.to(device) for n, v in draws.items()})
    b0 = fused_mhsa.BWD_LAUNCHES
    for _ in range(2):
        la = float(cpu.train_step(batch, 1e-3, 0.05)["loss"])
        lb = float(card.train_step(batch, 1e-3, 0.05)["loss"])
        assert np.isfinite(lb) and abs(la - lb) <= 2e-2 * abs(la), (la, lb)
    assert fused_mhsa.BWD_LAUNCHES - b0 == 8


# Tensor parallelism: B1-B4 at TimeSformer-B's (D 768, 12 heads, hidden
# 3072) shard shapes, tp = 2 and 4: attention width Da = 768 / tp (qkv's
# N = 3·Da = 1152, 576: not multiples of B1's 256-column tiles), 12 / tp
# heads, FFN hidden 3072 / tp, and the row product's bias zero (it is added
# after the all-reduce). (B, N, block_diag) of the dense spatial, packed
# temporal and long joint rows.
SHARD_ROWS = [(24, 197, 0, "dense"), (196, 8, 8, "packed"),
              (2, 1569, 0, "long")]


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("B,N,block_diag,variant", SHARD_ROWS)
def test_mhsa_at_tp_shard_shapes(cuda_device, tp, B, N, block_diag, variant):
    """B1 and B3 (whole call) on one model rank's heads against their plain
    versions, each gradient included; B3 twice to the same bits."""
    D, Da, H = 768, 768 // tp, 12 // tp
    rng = np.random.default_rng(tp * N + B)
    args = _mhsa_case(rng, B, N, D, Da, H)
    args[-1] = torch.zeros_like(args[-1])  # the row bias, outside
    cfg = (H, (Da // H) ** -0.5, 1e-5, False, block_diag)
    assert fused_mhsa.attention_variant(block_diag or N, Da // H) == variant
    out, qkv, attn, lse = fused_mhsa._launch(*args, *cfg)
    torch.cuda.synchronize()
    want = fused_mhsa._forward_reference(*[a.float() for a in args], *cfg)
    for name, a, b in zip(("out", "qkv", "attn"), (out, qkv, attn), want):
        assert a.shape == b.shape, name
        assert _rel_err(a, b) <= REL_TOL, (name, _rel_err(a, b))
    g = _bf16(rng, (B, N, D), 1.0)
    x, ln_w, ln_b, w_qkv, _, w_proj, _ = args
    bwd = (g, x, qkv, attn, lse, ln_w, ln_b, w_qkv, w_proj)
    counts = dict(fused_mhsa.ATTENTION_BWD_LAUNCHES)
    got = fused_mhsa._launch_backward(*bwd, *cfg)
    torch.cuda.synchronize()
    assert sum(fused_mhsa.ATTENTION_BWD_LAUNCHES.values()) == \
        sum(counts.values()) + 1
    want = fused_mhsa.fused_prenorm_mhsa_backward_reference(
        *[a.float() for a in bwd[:4] + bwd[5:]], *cfg)
    names = ("dx", "dln_w", "dln_b", "dw_qkv", "db_qkv", "dw_proj", "db_proj")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        assert _rel_err(a, b) <= REL_TOL, (name, _rel_err(a, b))
    again = fused_mhsa._launch_backward(*bwd, *cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
def test_ffn_at_tp_shard_shapes(cuda_device, tp):
    """B2 and B4 on one model rank's 3072 / tp hidden units (the rows of a
    train step's FFN call at 8 clips, 12552), fc2's bias zero."""
    M, D, hidden = 12552, 768, 3072 // tp
    rng = np.random.default_rng(tp)
    x = _bf16(rng, (M, D), 1.0)
    w = [_bf16(rng, (D,), 0.1, 1.0), _bf16(rng, (D,), 0.1),
         _bf16(rng, (hidden, D), 0.03), _bf16(rng, (hidden,), 0.03),
         _bf16(rng, (D, hidden), 0.03), torch.zeros(D, device="cuda",
                                                    dtype=torch.bfloat16)]
    out, h_pre = fused_ffn._launch(x, *w, 1e-5, True)
    torch.cuda.synchronize()
    want_out, want_h = fused_ffn._forward_reference(
        *[a.float() for a in (x, *w)], 1e-5)
    assert _rel_err(out, want_out) <= REL_TOL
    assert _rel_err(h_pre, want_h) <= REL_TOL
    g = _bf16(rng, (M, D), 1.0)
    args = (g, x, h_pre, w[0], w[1], w[2], w[4])
    got = fused_ffn._launch_backward(*args, 1e-5)
    torch.cuda.synchronize()
    want = fused_ffn.fused_prenorm_ffn_backward_reference(
        *[a.float() for a in args], 1e-5)
    names = ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        assert _rel_err(a, b) <= REL_TOL, (name, _rel_err(a, b))
    again = fused_ffn._launch_backward(*args, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
