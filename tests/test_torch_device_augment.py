"""The port's device augment against the JAX package's
``data/device_augment.py``, on the CPU.

The port takes its draws as tensors (``draws=``); ``jax_augment_draws``
rebuilds the JAX package's from a key with the same splits in the same
order (``split(key, B)``, then per clip ``split(k, 3)`` for the crop, the
flip and the jitter, ``rrc_params``' own four splits, ``color_jitter``'s
five, and for RandAugment one ``split(key, 3)`` per op draw), so both
packages apply the same crop boxes, flips, factors, orders and ops.

Tolerances, on pixel values in [0, 255]: 1e-3 for each continuous op (fp32
products and sums re-associated: a few ulps of 255), ``PIXEL_TOL`` for the
whole recipes, with normalised outputs taken back to pixels. The
nearest warps, Posterize, Solarize and Equalize are discontinuous: on the
same fp32 inputs they agree exactly, except where the two packages round
a warp's source coordinate differently (cos/sin and fused multiply-adds
differ in the last ulp), so the warps are held to a share of differing
pixels, 1%, and the whole RandAugment recipe, where the crop's rounding
can move a value across a Posterize, Solarize or Equalize step, to 0.1%.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videotransformer_tpu.data import device_augment as J
from videotransformer_tpu_torch.data import device_augment as P

COLOR = (0.4, 0.4, 0.4, 0.0)
# whole recipes, in pixel units: the crop's 16-tap fp32 sums (values to
# 255, weights to 1.1 in magnitude) re-associated, then scaled by up to
# three jitter factors of at most 1.4 (measured worst 1.4e-3)
PIXEL_TOL = 5e-3


def jax_augment_draws(key, b, h, w, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                      hflip=0.5, color=COLOR, auto_augment=False, num_ops=2):
    """The draws of JAX's ``augment_batch(key, ...)`` on a (b, T, h, w, C)
    batch, in the port's form (``device_augment.draw_augment``)."""
    box, flip, factors, order, ops, signs = [], [], [], [], [], []
    for k in jax.random.split(key, b):
        k_rrc, k_flip, k_jit = jax.random.split(k, 3)
        box.append([float(v) for v in J.rrc_params(k_rrc, h, w, scale,
                                                    ratio)])
        flip.append(bool(jax.random.uniform(k_flip) < hflip))
        if auto_augment:
            kk, o, s = k_jit, [], []
            for _ in range(num_ops):
                kk, k_op, k_sign = jax.random.split(kk, 3)
                o.append(int(jax.random.randint(k_op, (), 0, 14)))
                s.append(-1.0 if float(jax.random.uniform(k_sign)) > 0.5
                         else 1.0)
            ops.append(o)
            signs.append(s)
        elif any(color):
            kb, kc, ks, kh, kperm = jax.random.split(k_jit, 5)
            f = []
            for kf, strength in zip((kb, kc, ks), color[:3]):
                f.append(float(jax.random.uniform(
                    kf, minval=max(0, 1 - strength), maxval=1 + strength))
                    if strength else 1.0)
            f.append(float(jax.random.uniform(kh, minval=-color[3],
                                              maxval=color[3]))
                     if color[3] else 0.0)
            factors.append(f)
            order.append([int(v) for v in jax.random.permutation(kperm, 4)])
    draws = {"box": torch.tensor(box), "flip": torch.tensor(flip)}
    if auto_augment:
        draws["ra_ops"] = torch.tensor(ops)
        draws["ra_signs"] = torch.tensor(signs)
    elif any(color):
        draws["jitter_factors"] = torch.tensor(factors)
        draws["jitter_order"] = torch.tensor(order)
    return draws


def _batch(seed, b=3, t=2, h=40, w=52):
    return np.random.default_rng(seed).integers(0, 256, (b, t, h, w, 3),
                                                dtype=np.uint8)


def _pixels(seed, t=2, h=24, w=28, lo=-20.0, hi=275.0):
    """A float clip (T, H, W, C) with values outside [0, 255] too, as a
    bicubic crop leaves them."""
    return np.random.default_rng(seed).uniform(
        lo, hi, (t, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("h,w,box", [
    (40, 52, (3.0, 5.0, 20.0, 31.0)),
    (40, 52, (0.0, 0.0, 40.0, 52.0)),
    (52, 40, (11.0, 2.0, 41.0, 7.0)),
])
def test_resized_crop_matches_jax(h, w, box):
    clip = _pixels(1, h=h, w=w, lo=0.0, hi=255.0)
    want = np.asarray(J.resized_crop(jnp.asarray(clip), *box, 24, 18))
    got = P.resized_crop(torch.from_numpy(clip)[None],
                         torch.tensor([box]), 24, 18)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("color", [
    (0.4, 0.0, 0.0, 0.0), (0.0, 0.4, 0.0, 0.0), (0.0, 0.0, 0.4, 0.0),
    (0.0, 0.0, 0.0, 0.3), (0.4, 0.4, 0.4, 0.2)], ids=[
    "brightness", "contrast", "saturation", "hue", "all"])
def test_each_jitter_op_matches_jax(color):
    """One strength on at a time (the others run as identities, as in the
    JAX package), then all four in the drawn order."""
    clip = _pixels(2, lo=0.0, hi=255.0)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        # color_jitter's own draws from this key (device_augment.py:110-117)
        kb, kc, ks, kh, kperm = jax.random.split(key, 5)
        f = [float(jax.random.uniform(kf, minval=max(0, 1 - s),
                                      maxval=1 + s)) if s else 1.0
             for kf, s in zip((kb, kc, ks), color[:3])]
        f.append(float(jax.random.uniform(kh, minval=-color[3],
                                          maxval=color[3]))
                 if color[3] else 0.0)
        draws = {"jitter_factors": torch.tensor([f]),
                 "jitter_order": torch.tensor(
                     [[int(v) for v in jax.random.permutation(kperm, 4)]])}
        want = np.asarray(J.color_jitter(key, jnp.asarray(clip), *color))
        got = P.color_jitter(torch.from_numpy(clip)[None],
                             draws["jitter_factors"], draws["jitter_order"],
                             color)[0].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3,
                                   err_msg=str(seed))


@pytest.fixture(scope="module")
def ra_keys():
    """A key for each (op, sign) of a one-op ``rand_augment_clip``: the
    first of 1024 keys whose draw is that op and sign."""
    def draw(key):
        _, k_op, k_sign = jax.random.split(key, 3)
        return (jax.random.randint(k_op, (), 0, 14),
                jnp.where(jax.random.uniform(k_sign) > 0.5, -1.0, 1.0))

    keys = jax.random.split(jax.random.PRNGKey(11), 1024)
    ops, signs = jax.vmap(draw)(keys)
    found = {}
    for i, (op, sign) in enumerate(zip(np.asarray(ops), np.asarray(signs))):
        found.setdefault((int(op), float(sign)), keys[i])
    assert len(found) == 28, sorted(found)
    return found


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("op", range(14), ids=P.RA_OPS)
def test_each_rand_augment_op_matches_jax(ra_keys, op, sign):
    clip = _pixels(3 + op)
    want = np.asarray(J.rand_augment_clip(ra_keys[(op, sign)],
                                          jnp.asarray(clip), num_ops=1))
    got = P.rand_augment(torch.from_numpy(clip)[None],
                         torch.tensor([[op]]), torch.tensor([[sign]]))
    got = got[0].numpy()
    diff = np.abs(got - want) > 1e-3
    if P.RA_OPS[op] in ("ShearX", "ShearY", "Rotate"):
        assert diff.mean() <= 0.01, diff.mean()
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("recipe", [
    {"color": COLOR},
    {"color": (0.4, 0.4, 0.4, 0.1), "scale": (0.5, 1.0), "hflip": 0.3},
    {"auto_augment": True},
    {"color": (0, 0, 0, 0), "scale": (0.5, 1.0), "with_raw": True},
], ids=["supervised", "jitter_with_hue", "auto_augment", "mim_with_raw"])
def test_augment_batch_matches_jax(recipe):
    batch = _batch(4, b=4)
    kw = dict(recipe)
    with_raw = kw.pop("with_raw", False)
    draw_kw = {k: v for k, v in kw.items()
               if k in ("scale", "hflip", "color", "auto_augment")}
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        draws = jax_augment_draws(key, 4, 40, 52, **draw_kw)
        want = J.augment_batch(key, jnp.asarray(batch), out_size=24,
                               with_raw=with_raw, **kw)
        got = P.augment_batch(torch.from_numpy(batch), out_size=24,
                              with_raw=with_raw, draws=draws, **kw)
        pairs = list(zip(got, want)) if with_raw else [(got, want)]
        # in pixel units: the normalised output times 255 · std
        for (g, w), scale in zip(pairs, (255 * 0.225, 1.0)):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape == (4, 2, 3, 24, 24)
            err = np.abs(g - w) * scale
            if kw.get("auto_augment"):
                assert (err > PIXEL_TOL).mean() <= 1e-3, err.max()
            else:
                assert err.max() <= PIXEL_TOL, err.max()


@pytest.mark.parametrize("three_crop", [False, True])
@pytest.mark.parametrize("h,w", [(40, 52), (52, 40), (256, 342)])
def test_eval_preprocess_batch_matches_jax(h, w, three_crop):
    batch = _batch(5, b=2, t=2, h=h, w=w)
    want = np.asarray(J.eval_preprocess_batch(
        jnp.asarray(batch), img_size=32, three_crop=three_crop))
    got = P.eval_preprocess_batch(torch.from_numpy(batch), img_size=32,
                                  three_crop=three_crop).numpy()
    assert got.shape == want.shape == ((6 if three_crop else 2), 2, 3, 32, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# ------------------------------------------------------------ own draws

def test_crop_draws_stay_in_bounds_and_cover_the_scale():
    g = torch.Generator().manual_seed(0)
    h, w, n = 40, 52, 4000
    box = P.draw_crop(g, n, h, w, scale=(0.08, 1.0))
    top, left, ch, cw = box.unbind(1)
    assert (top >= 0).all() and (left >= 0).all()
    assert (top + ch <= h).all() and (left + cw <= w).all()
    assert (ch >= 1).all() and (cw >= 1).all()
    assert torch.equal(box, box.round())
    share = ch * cw / (h * w)
    # rounding each side to a whole pixel moves the share a little
    assert share.min() >= 0.06 and share.max() <= 1.0
    aspect = cw / ch
    assert aspect.min() >= 0.6 and aspect.max() <= 1.7
    # the first of 10 candidates fits almost always at these bounds
    assert share.mean() > 0.4


def test_crop_draw_falls_back_to_the_centre_crop():
    """No candidate fits a 10 x 100 image at scale >= 0.9 with aspect <=
    4/3, so every box is torchvision's fallback: height 10, width
    round(10 · 4/3) = 13, centred."""
    g = torch.Generator().manual_seed(1)
    box = P.draw_crop(g, 50, 10, 100, scale=(0.9, 1.0))
    assert torch.equal(box, torch.tensor([[0.0, 43.0, 10.0, 13.0]] * 50))
    want = [float(v) for v in J.rrc_params(jax.random.PRNGKey(0), 10, 100,
                                           (0.9, 1.0), (3 / 4, 4 / 3))]
    assert want == [0.0, 43.0, 10.0, 13.0]


def test_flip_jitter_and_rand_augment_draws():
    g = torch.Generator().manual_seed(2)
    n = 20000
    share = P.draw_flip(g, n, 0.3).float().mean().item()
    assert abs(share - 0.3) < 0.015, share
    factors, order = P.draw_jitter(g, n, (0.4, 0.2, 0.0, 0.1))
    assert (factors[:, 0] >= 0.6).all() and (factors[:, 0] <= 1.4).all()
    assert (factors[:, 1] >= 0.8).all() and (factors[:, 1] <= 1.2).all()
    assert (factors[:, 2] == 1.0).all()
    assert (factors[:, 3].abs() <= 0.1).all()
    assert torch.equal(order.sort(1).values, torch.arange(4).expand(n, 4))
    ops, signs = P.draw_rand_augment(g, n, 2)
    counts = torch.bincount(ops.flatten(), minlength=14).float()
    assert counts.shape == (14,)
    assert (abs(counts / (2 * n) - 1 / 14) < 0.01).all(), counts
    assert set(signs.unique().tolist()) == {-1.0, 1.0}
    assert abs((signs > 0).float().mean().item() - 0.5) < 0.015


@pytest.mark.parametrize("recipe", [
    {}, {"auto_augment": True}, {"color": (0, 0, 0, 0), "with_raw": True}])
def test_each_clip_gets_one_draw_for_all_its_frames(recipe):
    """Frames that are equal in the input stay equal in the output."""
    one = _batch(6, b=4, t=1)
    batch = torch.from_numpy(np.repeat(one, 3, axis=1))
    g = torch.Generator().manual_seed(3)
    out = P.augment_batch(batch, out_size=24, generator=g, **recipe)
    for x in out if recipe.get("with_raw") else [out]:
        assert torch.equal(x[:, 1], x[:, 0]) and torch.equal(x[:, 2], x[:, 0])
        assert not torch.equal(x[0], x[1])  # clips draw apart


def test_own_draws_are_applied_as_drawn():
    """augment_batch with a generator equals draw_augment from the same
    seed followed by augment_batch with those draws."""
    batch = torch.from_numpy(_batch(7))
    out = P.augment_batch(batch, out_size=24,
                          generator=torch.Generator().manual_seed(5))
    draws = P.draw_augment(torch.Generator().manual_seed(5), batch.shape)
    assert torch.equal(out, P.augment_batch(batch, out_size=24, draws=draws))
