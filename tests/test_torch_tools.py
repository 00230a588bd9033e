"""The port's host helpers and visualisation tools against the JAX package's,
on the CPU.

- ``utils/helpers.py``: ``denormalize`` bit-equal to JAX's;
  ``build_param_groups`` on a converted state dict equal to JAX's on the
  flax tree (names carried across by the converter) and to the groups of
  the trainer's optimizer.
- ``tools/visualize_attention.py`` and ``tools/visualize_maskfeat.py``:
  their numpy stages (the mass-threshold masks, the nearest upsample, the
  colored overlay, the viridis colormap, the HOG renderer) give the same
  bytes as the JAX tools' on the same arrays; their array stages agree
  with the JAX models on the same clip, mask, targets and weights (from
  the JAX tools' PRNGKey(0) initialisation, perturbed, carried across by
  the converter): the cls attention within 1e-5 (fp32, each weight in [0,
  1]; summation order only), MaskFeat's ``visualize=True`` outputs within
  1e-4 of max|ref| (the bound of tests/test_torch_mvit.py). Both tools
  write PNGs that are not constant, and refuse a card that is not there.

Tiny geometries: TimeSformer 2 frames at 32², embed 32, 4 heads, 2
layers; MaskFeat 4 frames at 64², depth 4, patch dim 32 (the JAX tool's
smoke test; two q-pool stages need depth 4), on the bundled demo clips.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videotransformer_tpu import config as vt_config
from videotransformer_tpu.data.hog import batched_hog_targets as j_hog
from videotransformer_tpu.models import TimeSformer as JTimeSformer
from videotransformer_tpu.models.convert import (
    flax_to_torch_state_dict, maskfeat_flax_to_torch_state_dict)
from videotransformer_tpu.models.maskfeat import MaskFeat as JMaskFeat
from videotransformer_tpu.tools import visualize_attention as jva
from videotransformer_tpu.tools import visualize_maskfeat as jvm
from videotransformer_tpu.utils import helpers as jhelpers
from videotransformer_tpu_torch.models import convert
from videotransformer_tpu_torch.tools import visualize_attention as va
from videotransformer_tpu_torch.tools import visualize_maskfeat as vm
from videotransformer_tpu_torch.training.optimizer import RefOptimizer
from videotransformer_tpu_torch.utils import helpers

DEMO = va.DEMO_DIR
ATTN_ARGV = ["--device", "cpu", "--image_size", "32", "--num_frames", "2",
             "--frame_interval", "4", "--embed_dims", "32", "--num_heads",
             "4", "--num_layers", "2",
             "--video", os.path.join(DEMO, "bar_slide_h_0.mp4")]
MF_ARGV = ["--device", "cpu", "--image_size", "64", "--num_frames", "4",
           "--frame_interval", "2", "--depth", "4", "--patch_embed_dim", "32",
           "--video", os.path.join(DEMO, "pulse_circle_0.mp4")]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are tiny: torch's intra-op threads would only
    contend with the other test processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _perturb(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32)
        * 0.05, params)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _as_torch(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


@pytest.fixture
def xla_attention():
    vt_config.set_attention_backend("xla")
    yield
    vt_config.set_attention_backend("auto")


# ---------------------------------------------------------------- helpers

def test_denormalize_bit_equal_to_jax():
    data = np.random.RandomState(0).randn(4, 3, 16, 16).astype(np.float32)
    data[0, 0, 0, :4] = [-10.0, 10.0, 0.0, -2.0]  # both clips, a zero
    mean, std = (0.45, 0.45, 0.45), (0.225, 0.225, 0.225)
    got = helpers.denormalize(data, mean, std)
    want = jhelpers.denormalize(data, mean, std)
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)


def _timesformer_tree():
    model = JTimeSformer(num_frames=2, img_size=32, patch_size=16,
                         embed_dims=32, num_heads=4,
                         num_transformer_layers=2)
    x = jnp.zeros((1, 2, 3, 32, 32))
    return jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), x)[
        "params"]), flax_to_torch_state_dict, convert.state_dict_to_jax_flat


def _maskfeat_tree():
    model = JMaskFeat(img_size=32, num_frames=4, depth=4,
                      patch_embed_dim=32,
                      embed_dim_mul=((1, 2.0), (3, 2.0)),
                      atten_head_mul=((1, 2.0), (3, 2.0)),
                      pool_q_stride_size=((1, 1, 2, 2), (3, 1, 2, 2)),
                      feature_dim=216)
    x = jnp.zeros((1, 4, 3, 32, 32))
    params = jax.jit(lambda k, v: model.init(k, v, None, None, None, None))(
        jax.random.PRNGKey(0), x)["params"]
    return (jax.device_get(params), maskfeat_flax_to_torch_state_dict,
            convert.maskfeat_state_dict_to_flat)


@pytest.mark.parametrize("tree", [_timesformer_tree, _maskfeat_tree],
                         ids=["timesformer", "maskfeat"])
def test_build_param_groups_match_jax_and_the_optimizer(tree):
    params, to_torch, to_flat = tree()
    sd = _as_torch(to_torch(params))
    no_decay, decay = helpers.build_param_groups(sd)
    assert sorted(no_decay + decay) == sorted(sd)
    # the same groups on the flax paths, each torch name carried back
    path = {name: next(iter(to_flat({name: p}))) for name, p in sd.items()}
    j_no_decay, j_decay = jhelpers.build_param_groups(params)
    assert sorted(path[n] for n in no_decay) == sorted(j_no_decay)
    assert sorted(path[n] for n in decay) == sorted(j_decay)
    # named_parameters() gives the same, and so does the optimizer
    named = [(n, torch.nn.Parameter(p)) for n, p in sd.items()]
    assert helpers.build_param_groups(named) == (no_decay, decay)
    opt = RefOptimizer(named)
    assert sorted(n for n, nd in opt.no_decay.items() if nd) == \
        sorted(no_decay)
    assert any("pos_embed" in n for n in no_decay + decay)


def test_timeit_wrapper_prints_and_returns(capsys):
    f = helpers.timeit_wrapper(lambda x: x + 1)
    assert f(1) == 2
    assert "cost time" in capsys.readouterr().out


def test_show_processed_image_writes_the_grid(tmp_path):
    imgs = np.random.RandomState(0).randn(2, 3, 8, 8, 3).astype(np.float32)
    path = helpers.show_processed_image(imgs, str(tmp_path), (0.45,) * 3,
                                        (0.225,) * 3, index=1)
    assert path == os.path.join(str(tmp_path), "processed_frames_1.png")
    assert os.path.getsize(path) > 0


def test_resolve_device_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert helpers.resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        helpers.resolve_device("cuda")


# ----------------------------------------------------------- numpy stages

def _stage_inputs():
    rng = np.random.RandomState(3)
    cls_attn = rng.rand(4, 16).astype(np.float32)
    cls_attn /= cls_attn.sum(1, keepdims=True)
    maps = cls_attn.reshape(4, 4, 4)
    th = jva.mass_threshold_masks(cls_attn, 0.6, 4)
    frame = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
    return cls_attn, maps, th, frame


STAGES = {
    "mass_threshold_masks": lambda m, a, maps, th, f: m.mass_threshold_masks(
        a, 0.6, 4),
    "upsample_nearest": lambda m, a, maps, th, f: m.upsample_nearest(maps, 16),
    "overlay_colors": lambda m, a, maps, th, f: m.overlay_colors(
        f, m.upsample_nearest(maps, 16), m.upsample_nearest(th, 16)),
    "colormap": lambda m, a, maps, th, f: m.colormap(
        m.upsample_nearest(maps, 16)[1]),
    "colormap_constant": lambda m, a, maps, th, f: m.colormap(
        np.full((5, 5), 0.25, np.float32)),
}


@pytest.mark.parametrize("stage", list(STAGES))
def test_attention_numpy_stages_give_jax_bytes(stage):
    inputs = _stage_inputs()
    got, want = STAGES[stage](va, *inputs), STAGES[stage](jva, *inputs)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("cell_px", [4, 8])
def test_render_hog_gives_jax_bytes(cell_px):
    cells = np.random.RandomState(cell_px).rand(3, 5, 9).astype(np.float32)
    got, want = vm.render_hog(cells, cell_px), jvm.render_hog(cells, cell_px)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


# ------------------------------------------------------------ array stages

def test_visualize_attention_cls_rows_match_jax():
    args = va.parse_args(ATTN_ARGV)
    video = va.load_video(args, np.random.default_rng(args.seed))
    assert video.shape == (2, 3, 32, 32) and video.dtype == np.float32
    jmodel = JTimeSformer(num_frames=2, img_size=32, patch_size=16,
                          embed_dims=32, num_heads=4,
                          num_transformer_layers=2,
                          attention_type="divided_space_time")
    x = jnp.asarray(video)[None]
    params = _perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(0), x)[
        "params"], 1)
    # the JAX tool's reduction on the device (visualize_attention.py:132)
    want = np.asarray(jax.jit(lambda p, v: jmodel.apply(
        {"params": p}, v, return_attention=True)[:, :, 0])(params, x))
    model = va.build_model(args)
    model.load_state_dict(_as_torch(flax_to_torch_state_dict(params)),
                          strict=True)
    got = va.cls_attention(model.eval(), video)
    assert got.shape == want.shape == (2, 4, 5)
    assert np.abs(got - want).max() <= 1e-5
    assert np.abs(got[..., 1:] - want[..., 1:]).max() <= 1e-5
    assert np.abs(got.sum(-1) - 1).max() <= 1e-5


def test_visualize_maskfeat_arrays_match_jax(xla_attention):
    args = vm.parse_args(MF_ARGV)
    rng = np.random.default_rng(args.seed)
    unnorm, norm_video = vm.load_video(args, rng)
    mask, cube_marker = vm.draw_mask(args, rng)
    assert cube_marker and mask.shape == (2, 4, 4)
    markers, counts = vm.pad_cube_marker([cube_marker], 8)
    muls = ((1, 2.0), (3, 2.0))
    jmodel = JMaskFeat(img_size=64, num_frames=4,
                       pool_q_stride_size=((1, 1, 2, 2), (3, 1, 2, 2)),
                       embed_dim_mul=muls, atten_head_mul=muls,
                       feature_dim=216, depth=4, patch_embed_dim=32)
    x = jnp.asarray(norm_video)[None]
    kw = dict(mask=jnp.asarray(mask[None].astype(np.int32)),
              cube_marker=jnp.asarray(markers),
              cube_count=jnp.asarray(counts))
    params = _perturb(jax.jit(lambda k, v: jmodel.init(
        k, v, target_x=None, **kw))(jax.random.PRNGKey(0), x)["params"], 2)
    model = vm.build_model(args)
    model.load_state_dict(
        _as_torch(maskfeat_flax_to_torch_state_dict(params)), strict=True)
    got = vm.maskfeat_arrays(model.eval(), unnorm, norm_video, mask,
                             cube_marker)
    # the JAX tool's targets (visualize_maskfeat.py:104-110)
    centers = vm.cube_centers(cube_marker)
    hog = np.asarray(j_hog(jnp.asarray(unnorm.transpose(0, 2, 3, 1))[None][
        :, centers]))
    assert _rel(got["target"][0, centers], hog[0]) <= 1e-5
    want = jax.jit(lambda p, v, t: jmodel.apply(
        {"params": p}, v, t, visualize=True, **kw))(
            params, x, jnp.asarray(got["target"]))
    for name, w in zip(("preds", "loss", "mask16", "hog_preds"), want):
        w = np.asarray(w)
        assert got[name].shape == w.shape, name
        assert _rel(got[name], w) <= 1e-4, name
    assert got["mask16"].sum() > 0


# ------------------------------------------------------------------- PNGs

def _pngs(path, names):
    from PIL import Image

    return {n: np.asarray(Image.open(os.path.join(path, n))) for n in names}


def test_visualize_attention_writes_pngs(tmp_path):
    va.main(ATTN_ARGV + ["--output_dir", str(tmp_path)])
    imgs = _pngs(tmp_path, [f"attn_img{i}.png" for i in range(2)])
    for img in imgs.values():
        assert img.ndim == 3 and img.shape[0] == 32
        assert img.std() > 0


def test_visualize_maskfeat_writes_pngs(tmp_path):
    vm.main(MF_ARGV + ["--output_dir", str(tmp_path)])
    imgs = _pngs(tmp_path, ["hog_pred.png", "real_img.png", "mask_img.png"])
    for name, img in imgs.items():
        assert img.std() > 0, name
    assert np.abs(imgs["real_img.png"].astype(int)
                  - imgs["mask_img.png"].astype(int)).sum() > 0


@pytest.mark.parametrize("tool", [va, vm], ids=["attention", "maskfeat"])
def test_tools_refuse_a_missing_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = list(ATTN_ARGV if tool is va else MF_ARGV)
    argv[argv.index("cpu") - 1:argv.index("cpu") + 1] = []  # the default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
