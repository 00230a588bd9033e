"""The port's TimeSformer slice against the JAX package's, on the CPU.

A tiny divided space-time TimeSformer (2 layers, D=64, 4 heads, 4 frames,
img 128: 65 spatial tokens, so the JAX fused-MHSA path engages) with every
parameter perturbed from a numpy seed (``temporal_fc`` nonzero). The JAX
model runs on its XLA path and on its Pallas path in interpret mode.
Tolerances: fp32 logits within 1e-4 · max|ref| (summation order only); bf16
within 5e-2 · max|ref| (bf16 rounds at slightly different points in flax's
modules and the port, compounded over two blocks).

Also: the converter against ``flax_to_torch_state_dict``, the parameters
of the space-only and joint space-time types, and the whole
port (serving, a TimeSformer training step, a ViViT step of each attention
type, a MaskFeat step with device HOG and a supervised MViT step) in a
subprocess where jax, flax and the JAX package cannot be imported."""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from videotransformer_tpu import config as vt_config
from videotransformer_tpu.models.convert import flax_to_torch_state_dict
from videotransformer_tpu.models.timesformer import TimeSformer as JTimeSformer
from videotransformer_tpu.ops.blocks import ClassificationHead as JHead
from videotransformer_tpu.serving.export import flatten_params
from videotransformer_tpu_torch.models.convert import (
    jax_flat_to_state_dict, split_artifact_params)
from videotransformer_tpu_torch.models.timesformer import (
    TimeSformer, get_vit_base_patch16_224)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(num_frames=4, img_size=128, patch_size=16, embed_dims=64,
           num_heads=4, num_transformer_layers=2)


def _jax_model(dtype=jnp.float32):
    return JTimeSformer(**CFG, drop_path_rate=0.0, dtype=dtype)


def _jax_params(seed=0):
    vt_config.set_attention_backend("xla")
    try:
        params = jax.jit(_jax_model().init)(
            jax.random.PRNGKey(seed),
            jnp.zeros((1, 4, 3, 128, 128)))["params"]
    finally:
        vt_config.set_attention_backend("auto")
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32) * 0.05,
        params)


def _port_model(params):
    model = TimeSformer(**CFG)
    model.load_state_dict(
        {k: torch.from_numpy(v)
         for k, v in jax_flat_to_state_dict(flatten_params(params)).items()},
        strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def slice_case():
    params = _jax_params()
    clip = np.random.RandomState(1).randn(1, 4, 3, 128, 128).astype(np.float32)
    return params, clip


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_slice_matches_jax(slice_case, backend, dtype):
    params, clip = slice_case
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    model = _jax_model(jdt)
    vt_config.set_attention_backend(backend)
    try:
        with pltpu.force_tpu_interpret_mode():
            want = jax.jit(lambda p, x: model.apply({"params": p}, x))(
                params, jnp.asarray(clip, jdt))
    finally:
        vt_config.set_attention_backend("auto")
    want = np.asarray(want.astype(jnp.float32))
    port = _port_model(params).to(getattr(torch, dtype))
    with torch.no_grad():
        got = port(torch.from_numpy(clip).to(getattr(torch, dtype)))
    got = got.float().numpy()
    assert got.shape == want.shape == (1, 64)
    assert np.isfinite(got).all()
    tol = 1e-4 if dtype == "float32" else 5e-2
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def test_temporal_fc_reaches_the_output(slice_case):
    """With temporal_fc zeroed the logits change: the temporal attention
    (the kernel's block-diagonal mode) is not hidden by the zero init."""
    params, clip = slice_case
    model = _port_model(params)
    with torch.no_grad():
        full = model(torch.from_numpy(clip))
        for layer in model.transformer_layers.layers:
            layer.attentions[0].temporal_fc.weight.zero_()
            layer.attentions[0].temporal_fc.bias.zero_()
        cut = model(torch.from_numpy(clip))
    assert (full - cut).abs().max() > 1e-2


def test_converter_matches_flax_to_torch_state_dict(slice_case):
    params, _ = slice_case
    head = JHead(10, 64)
    hparams = head.init(jax.random.PRNGKey(4), jnp.zeros((1, 64)))["params"]
    want = flax_to_torch_state_dict(params)
    want_head = flax_to_torch_state_dict(hparams)
    npz = {f"model/{k}": v for k, v in flatten_params(params).items()}
    npz.update({f"head/{k}": v for k, v in flatten_params(hparams).items()})
    got, got_head = split_artifact_params(npz)
    for g, w in ((got, want), (got_head, want_head)):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == np.float32
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    TimeSformer(**CFG).load_state_dict(
        {k: torch.from_numpy(v) for k, v in got.items()}, strict=True)
    assert set(got_head) == {"cls_head.weight", "cls_head.bias"}


def test_vit_base_builder_has_the_reference_names():
    with torch.device("meta"):
        model = get_vit_base_patch16_224(num_frames=8)
    sd = model.state_dict()
    assert sd["pos_embed"].shape == (1, 197, 768)
    assert sd["time_embed"].shape == (1, 8, 768)
    assert sd["patch_embed.projection.weight"].shape == (768, 3, 16, 16)
    assert "transformer_layers.layers.11.ffns.0.layers.0.0.weight" in sd
    assert "transformer_layers.layers.11.attentions.0.temporal_fc.weight" in sd
    assert "transformer_layers.layers.11.attentions.1.temporal_fc.weight" \
        not in sd


@pytest.mark.parametrize("attention_type", ["space_only",
                                            "joint_space_time"])
def test_attention_types_build_the_jax_parameters(attention_type):
    """The other two attention types build the JAX model's parameters: the
    names and shapes of flax_to_torch_state_dict, loaded strictly (their
    forward against the JAX model: tests/test_torch_joint.py)."""
    jmodel = JTimeSformer(**CFG, attention_type=attention_type,
                          drop_path_rate=0.0)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3),
                                  jnp.zeros((1, 4, 3, 128, 128)))["params"]
    want = flax_to_torch_state_dict(jax.device_get(params),
                                    attention_type=attention_type)
    model = TimeSformer(**CFG, attention_type=attention_type)
    got = model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    model.load_state_dict({k: torch.from_numpy(v) for k, v in want.items()},
                          strict=True)


def test_port_never_imports_jax():
    """No module of the port, nor chip_smoke.py, imports jax, flax or any
    module of the JAX package."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "videotransformer_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    port = os.path.join(REPO, "videotransformer_tpu_torch")
    for new in ("serving/export.py", "tools/export_serving.py",
                "tools/demo_inference.py", "models/convert.py",
                "parallel/mesh.py", "parallel/tp.py", "parallel/sp.py",
                "utils/helpers.py",
                "tools/mp_train_worker.py", "utils/__init__.py",
                "utils/profiling.py", "tools/visualize_attention.py",
                "tools/visualize_maskfeat.py", "benchmarks/__init__.py",
                "benchmarks/common.py", "benchmarks/trace_step.py",
                "benchmarks/trace_infer.py", "benchmarks/profile_train.py",
                "benchmarks/serve_bench.py", "benchmarks/run_all.py",
                "parallel/pp.py", "training/stacked_trainer.py",
                "training/pp_trainer.py", "graft_entry.py",
                "native/__init__.py", "native/videodec.py",
                "kernels/_ops.py", "kernels/mvit_pool.py", "native/videoenc.py",
                "tools/make_demo_assets.py"):
        assert os.path.join(port, new) in files, new
    banned = ("jax", "flax")
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in banned, f"{path} imports {m}"
                assert top != "videotransformer_tpu", (
                    f"{path} imports {m}, a module of the JAX package")


def test_slice_runs_with_jax_and_flax_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        sys.modules["videotransformer_tpu"] = None
        import importlib, pkgutil
        import numpy as np, torch
        import chip_smoke
        import videotransformer_tpu_torch as port
        for mod in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
            importlib.import_module(mod.name)  # every module of the port
        from videotransformer_tpu_torch.data.transforms import (
            eval_transform_clip)
        from videotransformer_tpu_torch.models.timesformer import TimeSformer
        from videotransformer_tpu_torch.ops.blocks import ClassificationHead
        from videotransformer_tpu_torch.serving.predictor import TorchPredictor
        from videotransformer_tpu_torch.serving.server import InferenceServer
        from videotransformer_tpu_torch.tools.demo_inference import load_clip
        from videotransformer_tpu_torch.training import trainer
        g = torch.Generator().manual_seed(0)
        model = TimeSformer(num_frames=4, img_size=128, embed_dims=64,
                            num_heads=4, num_transformer_layers=2)
        model.reset_parameters(g)
        head = ClassificationHead(10, 64)
        head.reset_parameters(g)
        manifest = {"num_frames": 4, "num_class": 10, "img_size": 128,
                    "n_crops": 3, "buckets": [1, 2]}
        pred = TorchPredictor(model, head, manifest, "cpu",
                              dtype=torch.float32)
        frames = np.random.RandomState(0).randint(
            0, 256, (4, 160, 200, 3), dtype=np.uint8)
        clip = eval_transform_clip(frames, (0.45,) * 3, (0.225,) * 3, 128)
        out = pred(clip[None])
        assert out.shape == (1, 10) and np.isfinite(out).all(), out
        # one bf16 train step (DropPath and mixup on) and an eval step
        from types import SimpleNamespace
        trainer.build_model = lambda c: TimeSformer(
            num_frames=2, img_size=32, embed_dims=64, num_heads=4,
            num_transformer_layers=2, drop_path_rate=0.1)
        cfg = SimpleNamespace(
            objective="supervised", arch="timesformer",
            attention_type="divided_space_time", num_class=10,
            num_frames=2, img_size=32, optim_type="adamw", clip_grad=1.0,
            seed=0, mixup=True, use_fp16=True)
        tr = trainer.VideoTransformerTrainer(cfg, "cpu")
        batch = {"video": np.random.RandomState(1).rand(
            4, 2, 3, 32, 32).astype(np.float32), "label": np.arange(4)}
        stats = tr.train_step(batch, 1e-3, 0.05)
        assert np.isfinite(float(stats["loss"])), stats
        assert int(tr.eval_step(batch, 1)["bs"]) == 4
        # a tiny ViViT step of each attention type
        from videotransformer_tpu_torch.models.vivit import ViViT
        trainer.build_model = lambda c: ViViT(
            num_frames=4, img_size=32, embed_dims=64, num_heads=4,
            num_transformer_layers=2, num_time_transformer_layers=2,
            attention_type=c.attention_type)
        clips = {"video": np.random.RandomState(3).rand(
            2, 4, 3, 32, 32).astype(np.float32), "label": np.arange(2)}
        for kind in ("fact_encoder", "joint_space_time",
                     "divided_space_time"):
            vcfg = SimpleNamespace(**{**vars(cfg), "arch": "vivit",
                                      "attention_type": kind,
                                      "num_frames": 4})
            vt = trainer.VideoTransformerTrainer(vcfg, "cpu")
            assert np.isfinite(float(vt.train_step(clips, 1e-3, 0.05)["loss"]))
        # a tiny MaskFeat (mim) step with device HOG from the raw clip, and
        # a supervised MViT step, through every MViT module of the port
        from videotransformer_tpu_torch.data.mask_generator import (
            CubeMaskGenerator, pad_cube_marker)
        from videotransformer_tpu_torch.kernels import flash_attention
        from videotransformer_tpu_torch.models.maskfeat import MaskFeat
        trainer.build_model = lambda c: MaskFeat(
            img_size=32, num_frames=4, depth=4,
            embed_dim_mul=((1, 2.0), (3, 2.0)),
            atten_head_mul=((1, 2.0), (3, 2.0)),
            pool_q_stride_size=((1, 1, 2, 2), (3, 1, 2, 2)))
        cfg.objective, cfg.arch, cfg.num_frames, cfg.mixup = \
            "mim", "mvit", 4, False
        gen = CubeMaskGenerator((2, 2, 2), mask_ratio=0.5, min_num_patches=1,
                                rng=np.random.default_rng(0))
        masks, markers = zip(*[gen() for _ in range(2)])
        marker, count = pad_cube_marker(markers, 2)
        video = np.random.RandomState(2).rand(2, 4, 3, 32, 32).astype(
            np.float32)
        mim = {"video": video, "raw": np.floor(video * 255),
               "mask": np.stack(masks), "cube_marker": marker,
               "cube_count": count}
        mt = trainer.VideoTransformerTrainer(cfg, "cpu")
        stats = mt.train_step(mim, 1e-3, 0.05)
        assert float(stats["loss"]) > 0 and float(stats["grad_norm"]) > 0
        cfg.objective, cfg.layer_decay = "supervised", 0.75
        st = trainer.VideoTransformerTrainer(cfg, "cpu")
        sup = {"video": video, "label": np.arange(2)}
        assert np.isfinite(float(st.train_step(sup, 1e-3, 0.05)["loss"]))
        assert int(st.eval_step(sup, 1)["bs"]) == 2
        assert flash_attention.LAUNCHES == 0  # the CPU runs the plain versions
        # the data path: the device augment, a raw_video step (supervised
        # and mim), the raw eval step, raw serving and the CLI's parser
        from videotransformer_tpu_torch import model_pretrain
        from videotransformer_tpu_torch.data import (
            dataset, device_augment, pipeline, rand_augment)
        from videotransformer_tpu_torch.training import data_module
        raw = torch.from_numpy(np.random.RandomState(4).randint(
            0, 256, (2, 4, 40, 52, 3)).astype(np.uint8))
        aug = device_augment.augment_batch(
            raw, out_size=32, auto_augment=True,
            generator=torch.Generator().manual_seed(0))
        assert aug.shape == (2, 4, 3, 32, 32)
        raw_mim = dict(mim, raw_video=raw.numpy())
        del raw_mim["video"], raw_mim["raw"]
        assert float(mt.train_step(raw_mim, 1e-3, 0.05)["loss"]) > 0
        raw_sup = {"raw_video": raw.numpy(), "label": np.arange(2)}
        assert np.isfinite(float(st.train_step(raw_sup, 1e-3, 0.05)["loss"]))
        assert int(st.eval_step(raw_sup, 3)["bs"]) == 2
        raw_pred = TorchPredictor(model, head, {
            **manifest, "input_mode": "raw", "input_shape": [4, 160, 200, 3],
            "input_dtype": "uint8"}, "cpu", dtype=torch.float32)
        assert raw_pred(frames[None]).shape == (1, 10)
        args = model_pretrain.parse_args([
            "-epoch", "1", "-batch_size", "2", "-num_class", "4",
            "-num_frames", "4", "-frame_interval", "4", "-lr", "0.1",
            "-root_dir", "r", "-train_data_path", "t.txt"])
        assert args.device == "cuda" and args.use_fp16 is True
        batches = list(pipeline.device_prefetch(pipeline.Loader(
            [(c, 0) for c in raw.numpy()], 2, collate_fn=pipeline.collate_raw,
            worker_timeout=30.0), "cpu"))
        assert batches[0]["raw_video"].dtype == torch.uint8
        # the checkpoint path: a reference .pth into the trainer, the
        # port's export read back by load_predictor, the tools' build_model
        import os, tempfile
        from videotransformer_tpu_torch.models import convert
        from videotransformer_tpu_torch.serving.export import (
            export_predictor)
        from videotransformer_tpu_torch.serving.predictor import (
            load_predictor)
        from videotransformer_tpu_torch.tools import (
            demo_inference, export_serving)
        with tempfile.TemporaryDirectory() as tmp:
            convert.save_reference_checkpoint(st.model, f"{tmp}/m.pth")
            ft = trainer.VideoTransformerTrainer(SimpleNamespace(
                **{**vars(cfg), "pretrain_pth": f"{tmp}/m.pth"}), "cpu")
            assert ft.pretrained_keys == ([], [])
            export_predictor(tmp, model, head, num_frames=4, num_class=10,
                             img_size=160, buckets=(1,),
                             dtype=torch.float32)
            big = load_predictor(tmp, "cpu", num_heads=4,
                                 dtype=torch.float32)
            big_clip = np.random.RandomState(5).rand(
                1, 3, 4, 3, 160, 160).astype(np.float32)
            assert np.isfinite(big(big_clip)).all()
        assert callable(export_serving.main) and callable(
            demo_inference.build_model)
        # the native FFmpeg decoder, built from the port's own source
        from videotransformer_tpu_torch.data.video_reader import VideoReader
        vr = VideoReader("videotransformer_tpu/data/assets/demo/"
                         "checker_spin_0.mp4", backend="native")
        assert vr.backend == "native" and len(vr) == 40
        assert vr.get_batch([39, 0]).shape == (2, 192, 256, 3)
        vr.close()
        blocked = ("jax", "flax", "videotransformer_tpu")
        assert all(sys.modules.get(m) is None for m in blocked)
        assert not [m for m in sys.modules
                    if m.startswith("videotransformer_tpu.")]
        print("OK", out.shape)
    """)
    # one thread: its models are tiny, and beside the other test processes
    # torch's full thread pool only contends for the cores (eight threads
    # took ~200 s here under load, one ~20 s)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK (1, 10)" in proc.stdout
