"""The references against the port on the CPU at small sizes (the test
imports both; the references import neither the port nor the JAX
package)."""

import ast
import json
import os

import pytest
import torch

from vtbench import seeds
from vtbench.reference import augment, hog, mvit, optim, precision
from vtbench.reference import timesformer as ref_tsf
from vtbench.tests import tiny

HERE = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(os.path.dirname(HERE), "reference")


def _config(name, **over):
    with open(os.path.join(tiny.REPO, "vtbench", "configs",
                           name + ".json")) as f:
        cfg = json.load(f)
    cfg.update(over)
    return cfg


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_references_import_nothing_of_the_port():
    for f in sorted(os.listdir(REF)):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REF, f)).read())
        for node in ast.walk(tree):
            names = [a.name for a in getattr(node, "names", [])] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            for n in names:
                assert n.split(".")[0] not in (
                    "videotransformer_tpu", "videotransformer_tpu_torch",
                    "jax", "flax"), (f, n)


def test_timesformer_matches_the_port():
    from videotransformer_tpu_torch.models.timesformer import TimeSformer
    from videotransformer_tpu_torch.ops.blocks import ClassificationHead

    cfg = _config("timesformer_b16_divst_8x224", **tiny.TSF)
    net = TimeSformer(num_frames=2, img_size=32, embed_dims=64, num_heads=4,
                      num_transformer_layers=2)
    head = ClassificationHead(10, 64)
    w = seeds.make_weights(7, ref_tsf.param_specs(cfg), "cpu")
    net.load_state_dict({k[6:]: v for k, v in w.items()
                         if k.startswith("model.")})
    head.load_state_dict({k[9:]: v for k, v in w.items()
                          if k.startswith("cls_head.")})
    video = torch.randn(3, 2, 3, 32, 32)
    net.eval()
    want = head(net(video))
    got = ref_tsf.logits(w, video, cfg, precision.Exact())
    assert (got - want).abs().max() < 1e-5 * want.abs().max() + 1e-6
    # DropPath from the same draws, fp32 on both sides
    net.train()
    g = torch.Generator().manual_seed(3)
    want = head(net(video, g))
    drops = ref_tsf.drop_path_draws(torch.Generator().manual_seed(3), cfg, 3,
                                    "cpu", dtype=torch.float32)
    assert any(d is not None for d in drops)
    got = ref_tsf.logits(w, video, cfg, precision.Exact(), drops)
    assert (got - want).abs().max() < 1e-5 * want.abs().max() + 1e-6


def test_augment_and_three_crop_match_the_port():
    from videotransformer_tpu_torch.data import device_augment as da

    raw = torch.randint(0, 256, (3, 2, 40, 54, 3), dtype=torch.uint8)
    recipe = dict(scale=[0.08, 1.0], hflip=0.5, color=[0.4, 0.4, 0.4, 0.0],
                  auto_augment=False, mean=[0.45] * 3, std=[0.225] * 3)
    draws = da.draw_augment(torch.Generator().manual_seed(5), raw.shape,
                            scale=(0.08, 1.0), color=(0.4, 0.4, 0.4, 0.0))
    mine = augment.draw(torch.Generator().manual_seed(5), raw.shape, recipe,
                        "cpu")
    for k in ("box", "flip", "jitter_order"):
        assert torch.equal(draws[k], mine[k]), k
    assert torch.equal(draws["jitter_factors"][:, :3], mine["jitter_factors"])
    want = da.augment_batch(raw, out_size=32, color=(0.4, 0.4, 0.4, 0.0),
                            draws=draws)
    got = augment.augment(raw, mine, recipe, 32)
    assert (got - want).abs().max() < 1e-4
    want = da.eval_preprocess_batch(raw, img_size=32, three_crop=True)
    got = augment.three_crop(raw, 32, recipe["mean"], recipe["std"])
    assert (got - want).abs().max() < 1e-4


def test_hog_matches_the_port():
    from videotransformer_tpu_torch.data.hog import batched_hog_targets

    frames = torch.rand(2, 32, 48, 3) * 255
    assert torch.allclose(hog.hog(frames), batched_hog_targets(frames),
                          atol=1e-6)


def test_maskfeat_matches_the_port():
    cfg = _config("mvit_b_maskfeat_16x224", **tiny.MVIT)
    net = tiny.tiny_model(type("C", (), {"objective": "mim"})())
    w = seeds.make_weights(5, mvit.param_specs(cfg), "cpu")
    assert set(w) == {"model." + k for k in net.state_dict()}
    net.load_state_dict({k[6:]: v for k, v in w.items()})
    B = 2
    video = torch.randn(B, 8, 3, 64, 64)
    mask = (torch.rand(B, 4, 4, 4) > 0.5).int()
    target = torch.randn(B, 8, 4, 4, 108)
    markers = torch.tensor([[[0, 1], [2, 2]]] * B, dtype=torch.int32)
    count = torch.tensor([2, 1], dtype=torch.int32)
    net.train()
    preds, loss = net(video, target, mask, markers, count, None)
    got = mvit.predictions(w, video, mask, cfg, precision.Exact())
    assert (got - preds).abs().max() < 1e-5 * preds.abs().max()
    m16 = mvit.loss_mask({"mask": mask, "cube_marker": markers,
                          "cube_count": count}, cfg)
    ref = (((got - target) ** 2).mean(-1) * m16).sum() / (m16.sum() + 1e-5)
    assert float(ref) == pytest.approx(float(loss.detach()), rel=1e-5)


def test_adamw_matches_the_port():
    from videotransformer_tpu_torch.training.optimizer import RefOptimizer

    shapes = {"model.a.weight": (4, 3), "model.a.bias": (4,),
              "model.pos_embed": (1, 2, 3)}
    start = {n: torch.randn(s) for n, s in shapes.items()}
    port = {n: torch.nn.Parameter(v.clone()) for n, v in start.items()}
    mine = {n: v.clone() for n, v in start.items()}
    opt, ref = RefOptimizer(list(port.items())), optim.AdamW(mine)
    for _ in range(3):
        grads = {n: torch.randn(s) for n, s in shapes.items()}
        for n, p in port.items():
            p.grad = grads[n].clone()
        opt.step(1e-2, 0.05)
        ref.step(grads, 1e-2, 0.05)
    for n in shapes:
        assert torch.allclose(port[n].detach(), mine[n], atol=1e-6), n


def test_the_control_differs_from_the_reference():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    exact, low = precision.Exact().matmul(a, b), precision.Fp8().matmul(a, b)
    gap = float((low - exact).abs().max() / exact.abs().max())
    assert 1e-3 < gap < 0.3
