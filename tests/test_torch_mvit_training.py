"""The port's supervised ``arch=mvit`` train step against the JAX package's
trainer, on the CPU: one step with layer-wise LR decay 0.75 from the same
parameters, with the depth-4 MaskFeat, the one-device JAX mesh and the
tolerances of tests/test_torch_mim_training.py, whose helpers it uses."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from test_torch_mim_training import LR, WD, _check_params, _flat, _pair
from videotransformer_tpu.parallel.mesh import shard_batch


def test_mvit_supervised_step_matches_jax_trainer(monkeypatch):
    """One supervised arch=mvit step with layer decay 0.75: the same loss,
    grad norm and parameters, decoder_pred bit-unchanged in both, and the
    same eval counts after it."""
    jt, pt, init = _pair(monkeypatch, objective="supervised")
    assert not any(n.startswith("model.decoder_pred")
                   for n in pt.optimizer.params)
    scales = pt.optimizer.lr_scales
    assert scales["model.mask_token"] == pytest.approx(0.75 ** 17)
    assert scales["model.mvit.blocks.2.attn.qkv.weight"] == \
        pytest.approx(0.75 ** 14)
    assert scales["cls_head.cls_head.weight"] == 1.0
    dec = {k: v.copy() for k, v in _flat(jt.params).items()
           if "decoder_pred" in k}
    rng = np.random.RandomState(3)
    batch = {"video": rng.rand(2, 4, 3, 32, 32).astype(np.float32),
             "label": np.array([1, 7], np.int32)}
    key = jax.random.fold_in(jt.base_key, 0)
    jt.params, jt.opt_state, js = jt._train_step(
        jt.params, jt.opt_state, shard_batch(jt.mesh, batch), key,
        jnp.float32(LR), jnp.float32(WD))
    ps = pt.train_step(batch, LR, WD)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(ps[k]), float(js[k]), rtol=1e-4,
                                   err_msg=k)
    _check_params(jt, pt, init)
    for tree in (_flat(jt.params), _flat(pt.params_tree())):
        for k, v in dec.items():
            np.testing.assert_array_equal(tree[k], v, err_msg=k)
    want = jt._eval_step(jt.params, shard_batch(jt.mesh, batch), 1)
    got = pt.eval_step(batch, 1)
    assert (int(got["top1"]), int(got["top5"]), int(got["bs"])) == \
        (int(want["top1"]), int(want["top5"]), int(want["bs"]))
