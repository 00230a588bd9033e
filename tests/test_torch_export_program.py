"""The kernels as ``vt::`` dispatcher ops, and the sealed serving program
(``serving/export.py``'s ``predict_b{B}.pt2``), on the CPU.

- ``torch.library.opcheck`` of ``vt::fused_prenorm_mhsa`` (dense,
  block-diagonal, long at head dim 64, Da != D, LayerNorm eps 1e-5 and
  1e-6, with and without the residual), ``vt::fused_prenorm_ffn`` (with and
  without h_pre, d_out != D) and ``vt::flash_attention`` (Nq != Nkv); each
  op's outputs are the plain version's, to the bit, with the shapes its
  fake implementation gives.
- Program artifacts of tiny TimeSformers (divided, joint, space_only) and
  ViViTs (fact_encoder, joint, divided), in clips and raw modes, traced in
  fp32: their logits against the JAX package's ``make_predict_fn`` /
  ``make_raw_predict_fn`` at tests/test_serving.py's bounds (rtol 1e-4,
  atol 1e-5), and bit-equal to the port's name-based predictor on the same
  weights (the same ops in the same order); bucket padding and chunking
  (B = 3 -> 4, B = 5 -> 4 + 1) as test_export_roundtrip_and_padding; a bf16
  program bit-equal to the bf16 name-based predictor.
- The graph holds the kernels: 2 B1 and 1 B2 nodes a divided block (1 and
  1 a joint one); a model whose blocks are patched to the plain versions
  traces to no ``vt::`` node, and the export refuses it.
- A head width other than 64 (128 wide, 4 heads) is served right without
  ``num_heads``, where the name-based predictor's guess (embed_dims // 64)
  is not.
- The program file holds no weights: an empty state dict, no example
  inputs, and only the resize weights as constants.
"""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_export import CLASSES, E, _models
from videotransformer_tpu import config as vt_config
from videotransformer_tpu.serving.export import (
    make_predict_fn as jax_make_predict_fn,
    make_raw_predict_fn as jax_make_raw_predict_fn)
from videotransformer_tpu_torch.kernels import (
    _ops, flash_attention, fused_ffn, fused_mhsa)
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.ops import blocks
from videotransformer_tpu_torch.ops.blocks import ClassificationHead
from videotransformer_tpu_torch.serving.export import (
    export_predictor, vt_op_counts)
from videotransformer_tpu_torch.serving.predictor import (
    TorchPredictor, load_predictor, program_file)

RTOL, ATOL = 1e-4, 1e-5  # tests/test_serving.py's
RAW_HW = (40, 48)
TYPES = [("timesformer", "divided_space_time"),
         ("timesformer", "joint_space_time"), ("timesformer", "space_only"),
         ("vivit", "fact_encoder"), ("vivit", "joint_space_time"),
         ("vivit", "divided_space_time")]


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            * scale + shift)


# -------------------------------------------------------------------- ops

# (B, N, D, Da, Do, heads, block_diag, ln_eps, add_residual)
MHSA_MODES = {
    "dense": (2, 16, 64, 64, 64, 4, 0, 1e-5, True),
    "block-diagonal": (2, 24, 64, 64, 64, 4, 8, 1e-5, True),
    "long": (1, 264, 64, 64, 64, 1, 0, 1e-6, False),
    "Da != D": (2, 16, 64, 128, 64, 4, 0, 1e-6, True),
    "no residual, Do != D": (2, 16, 64, 64, 32, 2, 0, 1e-5, False),
}


@pytest.mark.parametrize("mode", list(MHSA_MODES))
def test_opcheck_fused_prenorm_mhsa(mode):
    B, N, D, Da, Do, H, bd, eps, res = MHSA_MODES[mode]
    rng = np.random.default_rng(0)
    args = (_rand(rng, B, N, D), _rand(rng, D, scale=0.1, shift=1.0),
            _rand(rng, D, scale=0.1), _rand(rng, 3 * Da, D, scale=0.1),
            _rand(rng, 3 * Da, scale=0.1), _rand(rng, Do, Da, scale=0.1),
            _rand(rng, Do, scale=0.1))
    cfg = (H, (Da // H) ** -0.5, eps, res, bd)
    torch.library.opcheck(fused_mhsa.OP, (*args, *cfg))
    out, qkv, attn, lse = fused_mhsa.OP(*args, *cfg)
    want, want_qkv, want_attn, want_lse = fused_mhsa._forward_reference(
        *args, *cfg)
    assert torch.equal(out, want.reshape(B, N, Do))
    assert torch.equal(qkv, want_qkv) and torch.equal(attn, want_attn)
    L = bd or N
    if mode == "long":
        assert fused_mhsa.attention_variant(L, Da // H) == "long"
        assert lse.shape == (B * N // L, H, L) and torch.equal(lse, want_lse)
    else:
        assert lse.shape == (0,) and lse.dtype == torch.float32


@pytest.mark.parametrize("rows,D,hidden,Do,save", [
    ((2, 5), 64, 128, 64, True), ((10,), 64, 128, 64, False),
    ((3, 4), 64, 128, 32, True)])
def test_opcheck_fused_prenorm_ffn(rows, D, hidden, Do, save):
    rng = np.random.default_rng(1)
    args = (_rand(rng, *rows, D), _rand(rng, D, scale=0.1, shift=1.0),
            _rand(rng, D, scale=0.1), _rand(rng, hidden, D, scale=0.1),
            _rand(rng, hidden, scale=0.1), _rand(rng, Do, hidden, scale=0.1),
            _rand(rng, Do, scale=0.1))
    torch.library.opcheck(fused_ffn.OP, (*args, 1e-6, save))
    out, h_pre = fused_ffn.OP(*args, 1e-6, save)
    want, want_h = fused_ffn._forward_reference(*args, 1e-6)
    assert torch.equal(out, want.reshape(*rows, Do))
    assert torch.equal(h_pre, want_h) if save else h_pre.shape == (0,)


@pytest.mark.parametrize("shape_q,nkv,hd", [((2, 3, 10), 7, 32),
                                            ((1, 2, 33), 65, 96)])
def test_opcheck_flash_attention(shape_q, nkv, hd):
    rng = np.random.default_rng(2)
    q = _rand(rng, *shape_q, hd)
    k, v = (_rand(rng, *shape_q[:2], nkv, hd) for _ in range(2))
    torch.library.opcheck(flash_attention.OP, (q, k, v, hd ** -0.5))
    o, lse = flash_attention.OP(q, k, v, hd ** -0.5)
    want_o, want_lse = flash_attention._forward_reference(q, k, v, hd ** -0.5)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)


def test_op_refuses_real_meta_tensors():
    """The fake implementation serves traces only: a real tensor on the meta
    device raises, as any device but the CPU and the card does."""
    q = torch.empty(1, 1, 4, 32, device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        flash_attention.OP(q, q, q, 0.5)


# -------------------------------------------------------------- programs

@pytest.fixture
def xla():
    vt_config.set_attention_backend("xla")
    yield
    vt_config.set_attention_backend("auto")


def _inputs(pred, n, seed):
    rng = np.random.RandomState(seed)
    if pred.input_mode == "raw":
        return rng.randint(0, 256, (n, *pred.input_shape)).astype(np.uint8)
    return rng.rand(n, *pred.input_shape).astype(np.float32)


def _jax_by_buckets(fn, params, hparams, x, largest):
    """The JAX predict function over x as the predictors run it: chunks of
    the largest bucket, the last padded with zeros to a bucket (a ViViT
    fact_encoder's forward reads across the batch, its ``x[:b, 0]``, so the
    padding is part of the function)."""
    out = []
    for i in range(0, len(x), largest):
        chunk = x[i:i + largest]
        take = len(chunk)
        pad = 1 if take == 1 else largest
        chunk = np.concatenate([chunk, np.zeros((pad - take,) + x.shape[1:],
                                                x.dtype)])
        out.append(np.asarray(fn(params, hparams, jnp.asarray(chunk)))[:take])
    return np.concatenate(out)


@pytest.mark.parametrize("input_mode", ["clips", "raw"])
@pytest.mark.parametrize("arch,attention_type", TYPES)
def test_program_matches_jax_and_the_rebuilt_model(tmp_path, xla, arch,
                                                   attention_type,
                                                   input_mode):
    jmodel, model, jhead, head, params, hparams = _models(arch,
                                                          attention_type)
    path = str(tmp_path / "artifact")
    export_predictor(path, model, head, num_frames=4, num_class=CLASSES,
                     img_size=32, buckets=(1, 4), input_mode=input_mode,
                     raw_hw=RAW_HW, dtype=torch.float32)
    pred = load_predictor(path, "cpu")
    assert pred.model is None and sorted(pred.programs) == [1, 4]
    assert pred.dtype == torch.float32 and pred.buckets == [1, 4]
    rebuilt = load_predictor(path, "cpu", num_heads=4, dtype=torch.float32,
                             programs=False)
    if input_mode == "raw":
        jax_fn = jax_make_raw_predict_fn(jmodel, jhead, CLASSES, 3, 32)
    else:
        jax_fn = jax_make_predict_fn(jmodel, jhead, CLASSES, 3)
    for n, seed in ((3, 0), (5, 1)):  # 3 -> bucket 4; 5 -> 4 + 1
        x = _inputs(pred, n, seed)
        got = pred(x)
        assert got.shape == (n, CLASSES)
        np.testing.assert_allclose(got, _jax_by_buckets(jax_fn, params,
                                                        hparams, x, 4),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got, rebuilt(x))


def test_bf16_program_is_the_bf16_predictor(tmp_path):
    """The default working type: the bf16 program, and the bf16 model
    rebuilt from the same artifact, give the same bits."""
    _, model, _, head, _, _ = _models("timesformer", "divided_space_time")
    path = str(tmp_path / "artifact")
    export_predictor(path, model, head, num_frames=4, num_class=CLASSES,
                     img_size=32, buckets=(2,))
    pred = load_predictor(path, "cpu")
    assert pred.dtype == torch.bfloat16
    x = _inputs(pred, 2, 3)
    np.testing.assert_array_equal(
        pred(x), load_predictor(path, "cpu", num_heads=4,
                                programs=False)(x))
    with pytest.raises(ValueError, match="traced in"):
        load_predictor(path, "cpu", dtype=torch.float32)


@pytest.mark.parametrize("attention_type,b1,b2", [
    ("divided_space_time", 2, 1), ("joint_space_time", 1, 1)])
def test_graph_holds_the_kernels(tmp_path, attention_type, b1, b2):
    _, model, _, head, _, _ = _models("timesformer", attention_type)
    path = str(tmp_path / "artifact")
    export_predictor(path, model, head, num_frames=4, num_class=CLASSES,
                     img_size=32, buckets=(1,))
    program = torch.export.load(program_file(path, 1))
    layers = len(model.transformer_layers.layers)
    assert vt_op_counts(program) == {"fused_prenorm_mhsa": b1 * layers,
                                     "fused_prenorm_ffn": b2 * layers}
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["platforms"] == ["cpu", "cuda"]


def test_export_refuses_a_graph_without_the_kernels(tmp_path, monkeypatch):
    """Blocks patched to call the plain versions trace to aten ops alone:
    that program would run the plain versions on the card, so the export
    raises."""
    _, model, _, head, _, _ = _models("timesformer", "divided_space_time")
    monkeypatch.setattr(blocks.fused_mhsa, "fused_prenorm_mhsa",
                        fused_mhsa.fused_prenorm_mhsa_reference)
    monkeypatch.setattr(blocks.fused_ffn, "fused_prenorm_ffn",
                        fused_ffn.fused_prenorm_ffn_reference)
    with pytest.raises(RuntimeError, match="holds no vt:: op"):
        export_predictor(str(tmp_path / "a"), model, head, num_frames=4,
                         num_class=CLASSES, img_size=32, buckets=(1,))


def test_head_width_other_than_64_needs_no_head_count(tmp_path):
    """128 wide over 4 heads (head dim 32): the program carries the count;
    the name-based predictor without ``num_heads`` guesses 128 // 64 = 2
    and serves other logits."""
    g = torch.Generator().manual_seed(5)
    model = TimeSformer(num_frames=4, img_size=32, patch_size=16,
                        embed_dims=128, num_heads=4, num_transformer_layers=2)
    model.reset_parameters(g)
    head = ClassificationHead(CLASSES, 128)
    head.reset_parameters(g)
    path = str(tmp_path / "artifact")
    export_predictor(path, model, head, num_frames=4, num_class=CLASSES,
                     img_size=32, buckets=(2,), dtype=torch.float32)
    pred = load_predictor(path, "cpu")
    x = _inputs(pred, 2, 4)
    with torch.no_grad():
        want = head(model.eval()(torch.from_numpy(x).flatten(0, 1)))
    want = want.reshape(2, 3, CLASSES).mean(1).numpy()
    np.testing.assert_array_equal(pred(x), want)
    guessed = load_predictor(path, "cpu", dtype=torch.float32,
                             programs=False)
    assert np.abs(guessed(x) - want).max() > 1e-3 * np.abs(want).max()


@pytest.mark.parametrize("img_size", [32, 64])
def test_program_file_holds_no_weights(tmp_path, img_size):
    """At 32² no constant; at 64² the 2 -> 4 resize weights (two 2 x 4
    tables), beside ~70 k parameters in params.npz."""
    _, model, _, head, _, _ = _models("timesformer", "divided_space_time")
    path = str(tmp_path / "artifact")
    export_predictor(path, model, head, num_frames=4, num_class=CLASSES,
                     img_size=img_size, buckets=(1,))
    program = torch.export.load(program_file(path, 1))
    assert program.state_dict == {} and program.example_inputs is None
    constants = sum(t.numel() for t in program.constants.values())
    assert constants == (0 if img_size == 32 else 2 * 2 * 4)
    n_params = sum(p.numel() for p in model.parameters())
    with zipfile.ZipFile(program_file(path, 1)) as z:
        data = sum(i.file_size for i in z.infolist()
                   if "/data/" in i.filename and not
                   i.filename.endswith(".json"))
    assert data <= 4 * constants + 2048 < 4 * n_params
    assert E == 32 and n_params > 60_000


def test_predictor_from_programs_keeps_the_interface(tmp_path):
    """``TorchPredictor.from_programs`` over any modules of the programs'
    signature: bucket padding, chunking and unpadding as the model-built
    predictor does."""
    seen = []

    class Program(torch.nn.Module):
        def forward(self, params, head_params, x):
            seen.append(x.shape[0])
            return x.flatten(1)[:, :CLASSES].float() + params["w"]

    manifest = {"buckets": [2, 4], "num_class": CLASSES, "n_crops": 1,
                "num_frames": 1, "img_size": 4, "input_mode": "clips"}
    pred = TorchPredictor.from_programs(
        {2: Program(), 4: Program()}, {"w": torch.ones(())}, {}, manifest,
        "cpu", torch.float32)
    x = np.random.RandomState(6).rand(5, 1, 1, 3, 4, 4).astype(np.float32)
    got = pred(x)
    assert seen == [4, 2] and pred.max_batch == 4
    np.testing.assert_array_equal(got, x.reshape(5, -1)[:, :CLASSES] + 1)
    assert _ops.NAMESPACE == "vt"
