"""``kernels.mvit_pool`` on the CPU: the plain path of ``pool_qkv`` against
the pooling MViT ran before it, one ``F.conv3d`` a slice with the weight
cast and ``.repeat``-ed over the heads, bit for bit: the forward, the input
gradient and the weight gradient, at every pool geometry the port's MViT
schedules build (``build_mvit_block_configs``: MaskFeat as the trainer
builds it, MaskFeat's and MViT-B's three q-pool stages, the variants'
trunk, pytorchvideo's default s + 1 kernels), on reduced odd grids. The
fused backward's d_qkv against the three slices' gradients summed, and the
geometries the kernels refuse. The kernels themselves run on the card
(chip_smoke.py)."""

import itertools

import pytest
import torch
import torch.nn.functional as F

from videotransformer_tpu_torch.kernels import mvit_pool
from videotransformer_tpu_torch.models.mvit import build_mvit_block_configs

MVIT_B = dict(depth=16, num_heads=1, patch_embed_dim=96,
              embed_dim_mul=((1, 2.0), (3, 2.0), (14, 2.0)),
              atten_head_mul=((1, 2.0), (3, 2.0), (14, 2.0)))
SCHEDULES = {
    # models/maskfeat.py as training/trainer.py builds it
    "maskfeat": dict(MVIT_B, pool_q_stride_size=((1, 1, 2, 2), (3, 1, 2, 2)),
                     pool_kv_stride_adaptive=(1, 8, 8),
                     pool_kvq_kernel=(3, 3, 3)),
    # MaskFeat's defaults: MViT-B's three q-pool stages
    "mvit_b": dict(MVIT_B, pool_q_stride_size=((1, 1, 2, 2), (3, 1, 2, 2),
                                               (14, 1, 2, 2)),
                   pool_kv_stride_adaptive=(1, 8, 8),
                   pool_kvq_kernel=(3, 3, 3)),
    # tests/test_torch_mvit_variants.py's trunk
    "variants": dict(depth=2, patch_embed_dim=96, embed_dim_mul=((1, 2.0),),
                     atten_head_mul=((1, 2.0),),
                     pool_q_stride_size=((1, 1, 2, 2),),
                     pool_kv_stride_adaptive=(1, 2, 2),
                     pool_kvq_kernel=(3, 3, 3)),
    # pytorchvideo's default kernels, s + 1 where s > 1
    "s_plus_1": dict(MVIT_B, pool_q_stride_size=((1, 1, 2, 2), (3, 1, 2, 2),
                                                 (14, 1, 2, 2)),
                     pool_kv_stride_adaptive=(1, 8, 8)),
}


def _geometries():
    """{(C, head dim, q pool, k pool, v pool)} over the schedules' blocks,
    a pool as (kernel, stride) or None."""
    out = set()
    for kw in SCHEDULES.values():
        for b in build_mvit_block_configs(**kw)[0]:
            q = (b["kernel_q"], b["stride_q"]) if b["kernel_q"] else None
            kv = (b["kernel_kv"], b["stride_kv"]) if b["kernel_kv"] else None
            out.add((b["dim"], b["dim"] // b["num_heads"], q, kv, kv))
    return sorted(out, key=repr)


GEOMETRIES = _geometries()
GRID = (3, 9, 7)  # odd, and below every stride's window at 8


def _case(geometry, dtype, seed=0):
    C, hd, *pools = geometry
    g = torch.Generator().manual_seed(seed)
    B = 2
    qkv = torch.randn(B, GRID[0] * GRID[1] * GRID[2], 3 * C, generator=g)
    weights = [None if p is None else
               (torch.randn(hd, 1, *p[0], generator=g) * 0.3) for p in pools]
    return qkv.to(dtype), weights, pools


def _before(qkv, weights, pools):
    """The pools as models/mvit.py ran them before the kernels: a slice, a
    conv3d over (B, C, T, H, W) with the weight cast and tiled, back to
    token rows."""
    B, _, C3 = qkv.shape
    C = C3 // 3
    outs = []
    for i, (w, p) in enumerate(zip(weights, pools)):
        t = qkv[..., i * C:(i + 1) * C]
        if p is None:
            outs.append(t)
            continue
        kernel, stride = p
        wt = w.to(t.dtype).repeat(C // w.shape[0], 1, 1, 1, 1)
        u = F.conv3d(t.reshape(B, *GRID, C).permute(0, 4, 1, 2, 3), wt,
                     stride=stride, padding=[k // 2 for k in kernel],
                     groups=C)
        outs.append(u.permute(0, 2, 3, 4, 1).reshape(B, -1, C))
    return outs


def _run(fn, qkv, weights, pools, grads):
    x = qkv.clone().requires_grad_()
    ws = [None if w is None else w.clone().requires_grad_() for w in weights]
    outs = fn(x, ws, pools)
    torch.autograd.backward(outs, grads)
    return outs, x.grad, [None if w is None else w.grad for w in ws]


def _pool_qkv(x, ws, pools):
    return mvit_pool.pool_qkv(x, GRID, [None if p is None else (w, *p)
                                        for w, p in zip(ws, pools)])


def test_the_schedules_have_every_kind_of_pool():
    """The geometries cover q pools and k/v pools without a q pool, strides
    1, 2, 4 and 8, 3³ kernels and s + 1 ones, and C from 96 to 768."""
    strides = {p[1] for g in GEOMETRIES for p in g[2:] if p is not None}
    kernels = {p[0] for g in GEOMETRIES for p in g[2:] if p is not None}
    assert {(1, 1, 1), (1, 2, 2), (1, 4, 4), (1, 8, 8)} <= strides
    assert {(3, 3, 3), (1, 9, 9), (1, 3, 3)} <= kernels
    assert {g[0] for g in GEOMETRIES} == {96, 192, 384, 768}
    assert any(g[2] is None for g in GEOMETRIES)
    assert any(g[2] is not None for g in GEOMETRIES)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=repr)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_path_is_the_conv3d_it_replaced(geometry, dtype):
    qkv, weights, pools = _case(geometry, dtype)
    want = _before(qkv, weights, pools)
    g = torch.Generator().manual_seed(1)
    grads = [torch.randn(w.shape, generator=g).to(dtype) for w in want]
    got, dx, dws = _run(_pool_qkv, qkv, weights, pools, grads)
    want, want_dx, want_dws = _run(_before, qkv, weights, pools, grads)
    for o, w in zip(got, want):
        assert o.shape == w.shape and o.dtype == dtype
        assert torch.equal(o, w)
    assert torch.equal(dx, want_dx)
    for d, w in zip(dws, want_dws):
        assert (d is None) == (w is None)
        assert d is None or (d.dtype == torch.float32 and torch.equal(d, w))


@pytest.mark.parametrize("geometry", [g for g in GEOMETRIES if g[2]],
                         ids=repr)
def test_d_qkv_is_the_slices_gradients_summed(geometry):
    """The one backward's d_qkv is what the three slices' backwards gave,
    each a full-size zero-filled gradient, added."""
    qkv, weights, pools = _case(geometry, torch.float32, seed=2)
    outs = _pool_qkv(qkv, weights, pools)
    g = torch.Generator().manual_seed(3)
    grads = [torch.randn(o.shape, generator=g) for o in outs]
    _, dx, _ = _run(_pool_qkv, qkv, weights, pools, grads)
    total = torch.zeros_like(qkv)
    for i in range(3):
        x = qkv.clone().requires_grad_()
        out = _before(x, weights, pools)[i]
        (gx,) = torch.autograd.grad(out, x, grads[i])
        C = qkv.shape[-1] // 3
        assert not gx[..., :i * C].any() and not gx[..., (i + 1) * C:].any()
        total += gx
    assert torch.allclose(dx, total, rtol=1e-6, atol=1e-6)


def test_out_grid_is_conv3d_s():
    for kernel, stride in itertools.product(
            [(3, 3, 3), (1, 9, 9), (1, 3, 3), (2, 2, 2)],
            [(1, 1, 1), (1, 2, 2), (2, 4, 4), (1, 8, 8)]):
        x = torch.zeros(1, 1, *GRID)
        y = F.conv3d(x, torch.zeros(1, 1, *kernel), stride=stride,
                     padding=[k // 2 for k in kernel])
        assert mvit_pool.out_grid(GRID, kernel, stride) == tuple(y.shape[2:])


def test_no_pool_gives_the_slices():
    qkv = torch.randn(2, 3 * 9 * 7, 3 * 96)
    q, k, v = mvit_pool.pool_qkv(qkv, GRID, [None] * 3)
    assert torch.equal(torch.cat([q, k, v], -1), qkv)


@pytest.mark.parametrize("C,hd,kernels,why", [
    (100, 100, [(3, 3, 3)] * 2, "multiples of 8"),   # C, hd not of 8
    (96, 40, [(3, 3, 3)] * 2, "multiples of 8"),     # C not of hd
    (3200, 64, [(3, 3, 3)] * 2, "C <= 3072"),        # too many vectors a row
    (96, 96, [(1, 45, 45)] * 2, "shared memory"),    # tables too large
])
def test_refuses_what_the_kernels_do_not_take(C, hd, kernels, why):
    qkv = torch.randn(1, 3 * 9 * 7, 3 * C)
    pools = [None] + [(torch.zeros(hd, 1, *k), k, (1, 1, 1))
                      for k in kernels]
    with pytest.raises(ValueError, match=why):
        mvit_pool.pool_qkv(qkv, GRID, pools)


def test_refuses_pools_of_two_head_dims_and_a_wrong_weight():
    qkv = torch.randn(1, 3 * 9 * 7, 3 * 96)
    k = (3, 3, 3)
    with pytest.raises(ValueError, match="not one"):
        mvit_pool.pool_qkv(qkv, GRID, [None, (torch.zeros(96, 1, *k), k, k),
                                       (torch.zeros(48, 1, *k), k, k)])
    with pytest.raises(ValueError, match="weight"):
        mvit_pool.pool_qkv(qkv, GRID, [None, (torch.zeros(96, 1, 3, 3, 1),
                                              k, k), None])
    with pytest.raises(ValueError, match="for the grid"):
        mvit_pool.pool_qkv(qkv[:, 1:], GRID, [None] * 3)
