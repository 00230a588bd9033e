"""The port's ViViT with joint space-time attention against the
benchmark's plain reference (``vtbench/reference/vivit.py``), on the CPU.

A ViViT of the published geometry but a small width (D 64, 2 heads of 32,
2 layers, 10 classes; tubelets 2 x 16 x 16 of 224² clips) on seeded
random weights, the benchmark's own draw (``vtbench.seeds``), over 2
clips. At 32 frames a clip is 1 + 16 · 196 = 3137 tokens, so every joint
attention takes the unfused branch (LayerNorm, the qkv product, flash
attention's plain version, the projection); at 16 frames (1569 tokens)
the fused prenorm-MHSA call's plain version runs. Both sides compute in
float32 on the CPU.

Tolerances: features and logits within 1e-5 · max|reference| + 1e-6, the
loss within 1e-6 relative and every gradient leaf within 1e-4 · its
largest reference element + 1e-7. Both sides are float32 over the same
operands and differ only in the order of their sums (the port's LayerNorm
with explicit fp32 statistics, flash attention's plain version, the fused
calls' plain versions against torch's layer_norm, chunked attention and
F.linear); measured: 6e-7 on features of magnitude 2.7, losses equal,
gradients within 1.1e-6 of their leaf's largest element. A wrong token
order, table or draw moves them by whole percents.

Also: one ``train_step`` of the port's trainer (device augment, DropPath,
the head, the loss) against ``train_loss`` from the same draws, and the
reference loaded in a fresh interpreter loads neither the port nor JAX.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from videotransformer_tpu_torch.models.vivit import ViViT
from videotransformer_tpu_torch.ops import blocks
from videotransformer_tpu_torch.ops.blocks import ClassificationHead
from vtbench import seeds
from vtbench.reference import augment, precision
from vtbench.reference import vivit as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = dict(embed_dims=64, num_heads=2, num_transformer_layers=2,
             num_class=10)
CLIPS = 2


def _config(frames):
    with open(os.path.join(REPO, "vtbench", "configs",
                           "vivit_b16x2_joint_32x224.json")) as f:
        cfg = json.load(f)
    cfg.update(WIDTH, num_frames=frames)
    return cfg


def _model(frames):
    return ViViT(num_frames=frames, embed_dims=WIDTH["embed_dims"],
                 num_heads=WIDTH["num_heads"],
                 num_transformer_layers=WIDTH["num_transformer_layers"],
                 attention_type="joint_space_time")


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def unfused_calls(monkeypatch):
    """How many joint attentions took the unfused branch."""
    calls = []
    real = blocks.JointAttention._unfused

    def counted(self, *args):
        calls.append(args[0].shape[1])
        return real(self, *args)

    monkeypatch.setattr(blocks.JointAttention, "_unfused", counted)
    return calls


@pytest.mark.parametrize("frames,unfused", [(32, 2), (16, 0)])
def test_joint_features_and_logits_match_the_reference(frames, unfused,
                                                       unfused_calls):
    cfg = _config(frames)
    w = seeds.make_weights(5, ref.param_specs(cfg), "cpu")
    net, head = _model(frames), ClassificationHead(10, WIDTH["embed_dims"])
    net.load_state_dict({k[6:]: v for k, v in w.items()
                         if k.startswith("model.")})
    head.load_state_dict({k[9:]: v for k, v in w.items()
                          if k.startswith("cls_head.")})
    video = torch.randn(CLIPS, frames, 3, 224, 224,
                        generator=torch.Generator().manual_seed(1))
    net.eval()
    with torch.no_grad():
        feats = net(video)
        want = head(feats)
        got_feats = ref.features(w, video, cfg, precision.Exact())
        got = ref.logits(w, video, cfg, precision.Exact())
    assert unfused_calls == [1 + 196 * frames // 2] * unfused
    assert (got_feats - feats).abs().max() < \
        1e-5 * feats.abs().max() + 1e-6
    assert (got - want).abs().max() < 1e-5 * want.abs().max() + 1e-6
    # DropPath from the same draws, fp32 on both sides
    net.train()
    with torch.no_grad():
        want = head(net(video, torch.Generator().manual_seed(3)))
        drops = ref.drop_path_draws(torch.Generator().manual_seed(3), cfg,
                                    CLIPS, "cpu", dtype=torch.float32)
        got = ref.logits(w, video, cfg, precision.Exact(), drops)
    assert drops[0] is None and all(d is not None for d in drops[1:])
    assert (got - want).abs().max() < 1e-5 * want.abs().max() + 1e-6


@pytest.mark.parametrize("frames", [32, 16])
def test_a_train_step_matches_the_reference_train_loss(frames, monkeypatch):
    from videotransformer_tpu_torch.training import trainer as ptrainer

    cfg = _config(frames)
    aug = cfg["augment"]
    monkeypatch.setattr(ptrainer, "build_model", lambda c: _model(
        c.num_frames))
    configs = SimpleNamespace(
        objective="supervised", arch="vivit",
        attention_type="joint_space_time", num_class=10, num_frames=frames,
        img_size=224, optim_type="adamw", clip_grad=0.0, seed=11,
        mixup=False, eval_metrics="finetune", use_fp16=False,
        aug_scale=tuple(aug["scale"]), aug_hflip=aug["hflip"],
        aug_color=tuple(aug["color"]), auto_augment=None,
        data_statics="kinetics")
    trainer = ptrainer.VideoTransformerTrainer(configs, "cpu")
    w = seeds.make_weights(5, ref.param_specs(cfg), "cpu")
    params = trainer.optimizer.params
    assert set(params) == set(w)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(w[n])
    g = torch.Generator().manual_seed(2)
    batch = {"raw_video": torch.randint(0, 256, (CLIPS, frames, 232, 240, 3),
                                        generator=g, dtype=torch.uint8),
             "label": torch.tensor([3, 7])}
    stats = trainer.train_step(batch, 1e-3, 0.05)
    # the trainer's first step seeds its generator with seed + 0 + 7919
    g = torch.Generator().manual_seed(11 + 7919)
    draws = {"aug": augment.draw(g, batch["raw_video"].shape, aug, "cpu"),
             "drop": ref.drop_path_draws(g, cfg, CLIPS, "cpu",
                                         dtype=torch.float32)}
    mine = {n: t.clone().requires_grad_() for n, t in w.items()}
    loss = ref.train_loss(mine, batch, draws, 0, CLIPS, cfg,
                          precision.Exact())
    loss.backward()
    assert float(stats["loss"]) == pytest.approx(float(loss.detach()),
                                                 rel=1e-6)
    for n, p in mine.items():
        scale = float(p.grad.abs().max())
        assert (params[n].grad - p.grad).abs().max() <= \
            1e-4 * scale + 1e-7, n


def test_the_reference_loads_neither_the_port_nor_jax():
    code = ("import json, sys; import vtbench.reference.vivit;"
            " print(json.dumps(sorted({m.split('.')[0]"
            " for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout)
    assert "vtbench" in loaded and "torch" in loaded
    assert [m for m in loaded if m.startswith("videotransformer_tpu")
            or m in ("jax", "jaxlib", "flax")] == []
